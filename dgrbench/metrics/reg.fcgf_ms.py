"""The batched program's fcgf stage, ms a pair (``batch_stage_timers``;
the program synchronises the stream at each stage edge)."""


def read(ctx):
    if ctx["kind"] != "register" or not ctx["pairs"]:
        return None
    return 1000.0 * ctx["stage_s"]["fcgf"] / ctx["pairs"]
