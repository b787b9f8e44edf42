"""Seconds from the start of the process to the window: imports, the
program's construction, inputs and weights, kernel builds and warm-up."""


def read(ctx):
    return ctx["setup_s"]
