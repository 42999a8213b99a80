"""Camera rendering: fleet world state → grayscale, RGB and semantic frames
(scene assembly → 2D-homogeneous projection → band rasterization).
``render.pipeline.make_renderer`` is the entry point."""
