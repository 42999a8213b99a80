"""Kernel B's (``csrc/raster_fast.cu``) share of its roofline, in %: the
least time its frames need ÷ its device time in the trace.

The least time of one frame is the larger of its bytes ÷ the HBM rate and
its operations ÷ the fp32 rate outside the tensor cores. Counted from the
frames' inputs, whatever implements the kernel: the bytes are the scene's
triangles that pass its cull read once (13 float32 coefficients each) and
the 8-bit observation written once; the operations are 21 for every
(triangle, pixel) pair in which the triangle covers the pixel (three edge
functions of 4, the depth numerator 4, their sum 2, the divide 2, the
depth test 1) and 4 a pixel for the shading. The counts per frame are
the means over the frames the correctness check rendered with the plain
reference. Returns the share and which of the two bounds it."""

KERNEL = "fast_band_kernel"
OPS_PER_PAIR, OPS_PER_PIXEL, BYTES_PER_TRIANGLE, BYTES_PER_PIXEL = 21, 4, 52, 1


def read(ctx):
    trace, facts = ctx["trace"], ctx["facts"]
    if not trace or "covering_pairs_per_frame" not in facts:
        return None
    hits = [v for name, v in trace["kernels"].items() if KERNEL in name]
    seconds, launches = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not launches or seconds <= 0.0:
        return None
    frames = launches * facts["n_envs"]
    ops = frames * (OPS_PER_PAIR * facts["covering_pairs_per_frame"]
                    + OPS_PER_PIXEL * facts["pixels_per_frame"])
    nbytes = frames * (BYTES_PER_TRIANGLE * facts["kept_triangles_per_frame"]
                       + BYTES_PER_PIXEL * facts["pixels_per_frame"])
    t_ops, t_bytes = ops / ctx["peaks"]["fp32_flops"], nbytes / ctx["peaks"]["hbm_bytes_per_s"]
    return {"value": 100.0 * max(t_ops, t_bytes) / seconds,
            "bound": "operations" if t_ops >= t_bytes else "bytes"}
