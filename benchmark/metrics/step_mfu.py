"""The whole step's share of the card's float32 peak (%): the net FLOPs of
the window's training (both seats' forwards for every training env-step,
and every sampled row's update work, ``benchmark/models/``) over the
window's wall time, against 67 TFLOP/s. The gates' forwards are not
counted: the loop does not say how many env-steps a gate played."""

import importlib

from benchmark.peaks import F32_FLOPS


def read(ctx):
    if not ctx.spans:
        return None
    model = importlib.import_module(
        f"benchmark.models.{ctx.run['config']['reference']}")
    d = ctx.d
    steps = sum(s["env_steps"] for s in ctx.spans)
    rows = sum(s["updates"] for s in ctx.spans) * d["batch_size"]
    flops = 2 * model.forward_flops(d) * steps + model.row_flops(d) * rows
    return 100.0 * flops / ctx.window_s / F32_FLOPS
