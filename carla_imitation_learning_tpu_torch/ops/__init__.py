"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions:
``raster`` (exact z-buffer, kernel A, flat and textured) and ``raster_fast``
(grayscale rollout kernels: B, the fused-quad C and the grouped-table D);
``texture`` holds the procedural texture factor kernel A's textured variant
repeats."""
