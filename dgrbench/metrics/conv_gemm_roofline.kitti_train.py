"""The conv GEMMs' share of their roofline in the traced steps: the useful
conv FLOPs (2 E Cin Cout a pass on the benchmark's own maps: the inlier
net's forward, input and kernel gradients, FCGF's forward) over the device
seconds of every GEMM kernel at the float32 dense peak (67 TFLOP/s). Tile
padding, the first convs' occupancy products and the other GEMMs of the
step count as time and not as work."""

from dgrbench.metrics import kernel_s, model_flops, traced
from dgrbench.roofline import F32_FLOPS

KERNELS = ("gemm", "gemv", "splitKreduce")


def read(ctx):
    if not traced(ctx, "train"):
        return None
    t = kernel_s(ctx, KERNELS)
    f = model_flops(ctx["traced_work"]["convs"])
    return 100.0 * f / (t * F32_FLOPS) if t > 0 and f > 0 else None
