"""Share of the pairs that the batched program handed back to register()
(its gate bit or candidate lists failed): ``last_batch["rerun"]``."""


def read(ctx):
    if ctx["kind"] != "register" or not ctx["pairs"]:
        return None
    return 100.0 * ctx["reruns"] / ctx["pairs"]
