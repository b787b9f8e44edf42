"""One reader a metric, ``<metric name>.py``, each with ``read(ctx)``: the
metric's value from the run's context, or None where the run gives it
nothing to read (a reader never returns 0 for a share of a roofline or a
peak). The helpers below are shared by the readers.

The context: ``kind`` ("register" or "train"), ``work`` (pairs the window
completed), ``window_s``, ``setup_s``, the driver's ``layer_context()``
and, in a traced run, ``busy_s``, ``trace_window_s``, ``kernels`` (device
name -> (seconds, launches)) and ``traced_work`` (the traced calls' convs
and 1-NN searches, counted by the benchmark's own maps).
"""

from __future__ import annotations

from ..roofline import conv_flops, slot_sum_bytes


def kernel_s(ctx, names) -> float:
    """Device seconds of the traced kernels whose name holds one of names."""
    return sum(s for k, (s, _) in ctx.get("kernels", {}).items()
               if any(n in k for n in names))


def traced(ctx, kind: str) -> bool:
    return ctx["kind"] == kind and "traced_work" in ctx


def slot_sum_by_row_bytes(convs) -> int:
    """Bytes of every by-row slot sum the convs need: each sparse conv's
    forward (FCGF's first conv takes an all-ones input, which the program
    computes as an occupancy product and not by a slot sum) and, for a
    trained net, each input gradient but the first conv's (its input needs
    none)."""
    total = 0
    for c in convs:
        if c["kind"] == "k1" or (c["kind"] == "first" and c["net"] == "fcgf"):
            continue
        total += slot_sum_bytes(c["edges"], c["rows_out"], c["cout"])
        if c["trained"] and c["kind"] != "first":
            total += slot_sum_bytes(c["edges"], c["rows_in"], c["cin"])
    return total


def model_flops(convs) -> int:
    """2 E Cin Cout a pass of every conv: the forward, and for a trained net
    the kernel gradient and (but the first conv) the input gradient."""
    total = 0
    for c in convs:
        f = conv_flops(c["edges"], c["cin"], c["cout"])
        passes = 1
        if c["trained"]:
            passes += 1 + (c["kind"] != "first")
        total += passes * f
    return total
