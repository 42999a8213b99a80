"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions:
``raster`` (exact z-buffer, kernel A) and ``raster_fast`` (grayscale
rollout kernel, kernel B)."""
