"""The 1-NN kernels' share of their roofline in the traced calls: the least
time of every search (``roofline.nn1_bound_s``) over their device time
(the packing kernel each launch runs first included)."""

from dgrbench.metrics import kernel_s, traced
from dgrbench.roofline import nn1_bound_s

KERNELS = ("mma_kernel", "scan_kernel", "pack_kernel")


def read(ctx):
    if not traced(ctx, "register"):
        return None
    t = kernel_s(ctx, KERNELS)
    need = sum(n * nn1_bound_s(kind, n0, n1, c)
               for kind, n0, n1, c, n in ctx["traced_work"]["nn1"])
    return 100.0 * need / t if t > 0 and need > 0 else None
