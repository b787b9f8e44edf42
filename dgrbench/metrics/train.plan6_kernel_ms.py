"""Device ms a profiled train step launched inside the span
``dgr.train.plan6`` (the 6D plan's kernel maps; ``dgrbench/spans.py``)."""

from dgrbench.spans import per_step


def read(ctx):
    return per_step(ctx, "dgr.train.plan6", "device_s", 1000.0)
