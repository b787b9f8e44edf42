"""The by-row slot-sum kernel's share of its roofline in the traced calls:
the least time its bytes need at 3.35 TB/s over its device time."""

from dgrbench.metrics import kernel_s, slot_sum_by_row_bytes, traced
from dgrbench.roofline import HBM_BYTES_S

KERNELS = ("slot_sum_kernel",)


def read(ctx):
    if not traced(ctx, "train"):
        return None
    t = kernel_s(ctx, KERNELS)
    need = slot_sum_by_row_bytes(ctx["traced_work"]["convs"]) / HBM_BYTES_S
    return 100.0 * need / t if t > 0 and need > 0 else None
