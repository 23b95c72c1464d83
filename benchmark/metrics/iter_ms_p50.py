"""Median host wall time of the window's ``train_iteration`` calls (ms)."""

import statistics


def read(ctx):
    if not ctx.spans:
        return None
    return 1e3 * statistics.median(s["t1"] - s["t0"] for s in ctx.spans)
