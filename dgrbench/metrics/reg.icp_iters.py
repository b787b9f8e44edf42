"""ICP iterations a pair in the batched program (``last_batch["icp"]``, pairs
that passed the gate)."""


def read(ctx):
    it = ctx.get("icp_iters") if ctx["kind"] == "register" else None
    return sum(it) / len(it) if it else None
