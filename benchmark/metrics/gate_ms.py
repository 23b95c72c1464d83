"""Mean gate time: the loop's ``eval_s`` summed over the window's gates,
over the gates run (ms)."""


def read(ctx):
    if not ctx.eval_s:
        return None
    return 1e3 * sum(ctx.eval_s) / len(ctx.eval_s)
