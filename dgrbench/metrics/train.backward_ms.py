"""The train step's backward stage, ms a step (``make_train_step(..., timers=)``,
which synchronises the card at each stage edge: traced runs only)."""


def read(ctx):
    st = ctx.get("train_stage_s") if ctx["kind"] == "train" else None
    if not st or not ctx["steps"]:
        return None
    return 1000.0 * st["backward"] / ctx["steps"]
