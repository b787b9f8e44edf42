"""The model's FLOPs in the traced calls (2 E Cin Cout a conv pass over both
nets; forward only for a frozen net, forward, input and kernel gradients
for the trained one) over the traced window, as a share of the float32
dense peak (67 TFLOP/s), the precision the configuration's convs state."""

from dgrbench.metrics import model_flops, traced
from dgrbench.roofline import F32_FLOPS


def read(ctx):
    if not traced(ctx, "train"):
        return None
    f = model_flops(ctx["traced_work"]["convs"])
    return 100.0 * f / ctx["trace_window_s"] / F32_FLOPS if f > 0 else None
