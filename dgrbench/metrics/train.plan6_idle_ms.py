"""Ms a profiled train step in which the card ran nothing while the host
was in the span ``dgr.train.plan6`` (``dgrbench/spans.py``)."""

from dgrbench.spans import per_step


def read(ctx):
    return per_step(ctx, "dgr.train.plan6", "idle_s", 1000.0)
