"""The loop's own time a try (ms): the window less its ``train_iteration``
calls and its gates (opponent stacks and their preparation, checkpoint
saves, learner resets, the loop's bookkeeping), over the tries begun in
the window."""


def read(ctx):
    if not ctx.tries:
        return None
    iters = sum(s["t1"] - s["t0"] for s in ctx.spans)
    return 1e3 * (ctx.window_s - iters - sum(ctx.eval_s)) / ctx.tries
