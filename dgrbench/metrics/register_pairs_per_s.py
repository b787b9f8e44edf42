"""Pairs whose pose came back in the window, over the window (calls whole)."""


def read(ctx):
    return ctx["work"] / ctx["window_s"] if ctx["kind"] == "register" else None
