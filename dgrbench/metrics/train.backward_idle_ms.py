"""Ms a profiled train step in which the card ran nothing while the host
was in the span ``dgr.train.backward`` (``dgrbench/spans.py``)."""

from dgrbench.spans import per_step


def read(ctx):
    return per_step(ctx, "dgr.train.backward", "idle_s", 1000.0)
