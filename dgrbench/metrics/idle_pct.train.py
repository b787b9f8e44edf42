"""Share of the traced window in which no kernel, copy or set ran on the
card (the union of their intervals counts once)."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["trace_window_s"])
