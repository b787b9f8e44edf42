"""The host's waits on the card (stream, device and event synchronisations,
synchronous copies) a profiled train step, inside the span
``dgr.train.step`` (``dgrbench/spans.py``)."""

from dgrbench.spans import per_step


def read(ctx):
    return per_step(ctx, "dgr.train.step", "waits")
