"""step.host_ms: the host's ms from the call of
``l2_loss_and_grads_sparse`` to its return, the mean over the window's
steps (the benchmark's span)."""


def read(ctx):
    steps = ctx.get("spans", {}).get("step")
    return sum(steps) / len(steps) * 1e3 if steps else None
