"""The benchmark's plain reference: what the timed path of the port must
compute, written in plain PyTorch and importing nothing of the port.

``sim/``, ``render/`` and ``actions.py`` are frozen copies of the port's
plain simulator, scene assembly and projection, kept as they were when the
benchmark was defined and never updated to follow the port. ``raster.py``
is a plain per-pixel z-buffer with kernel B's shading rules, ``models.py``
the two policies in float32, ``train.py`` the loss, the clip and Adam.
"""
