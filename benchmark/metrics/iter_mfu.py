"""The learner's share of the card's float32 peak inside its iterations
(%): the FLOPs ``step_mfu`` counts (``benchmark/models/``), over the
summed wall time of the window's ``train_iteration`` calls, against 67
TFLOP/s."""

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
    wall = sum(s["t1"] - s["t0"] for s in ctx.spans)
    flops = 2 * model.forward_flops(d) * steps + model.row_flops(d) * rows
    return 100.0 * flops / wall / F32_FLOPS
