"""Device ms a profiled train step launched inside the span
``dgr.train.backward``, the autograd thread's launches included
(``dgrbench/spans.py``)."""

from dgrbench.spans import per_step


def read(ctx):
    return per_step(ctx, "dgr.train.backward", "device_s", 1000.0)
