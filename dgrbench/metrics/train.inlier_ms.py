"""The train step's inlier stage (the 6D net's forward), ms a step
(``make_train_step(..., timers=)``: the stage's interval on the card's
timeline, CUDA events read after the window; traced runs only)."""


def read(ctx):
    st = ctx.get("train_stage_s") if ctx["kind"] == "train" else None
    if not st or not ctx["steps"] or "inlier" not in st:
        return None
    return 1000.0 * st["inlier"] / ctx["steps"]
