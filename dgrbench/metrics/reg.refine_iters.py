"""Refinement iterations a pair in the batched program (``last_batch["refine"]``,
pairs that passed the gate)."""


def read(ctx):
    it = ctx.get("refine_iters") if ctx["kind"] == "register" else None
    return sum(it) / len(it) if it else None
