"""Pairs trained in the window (batch x steps), over the window."""


def read(ctx):
    return ctx["work"] / ctx["window_s"] if ctx["kind"] == "train" else None
