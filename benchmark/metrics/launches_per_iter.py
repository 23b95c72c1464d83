"""Device kernels launched from inside the traced ``train_iteration``
calls, per call (memory copies and sets not counted)."""


def read(ctx):
    if not ctx.traced_spans or not ctx.kernels:
        return None
    n = sum(1 for e in ctx.kernels if e["phase"] == "iteration"
            and not e["name"].startswith("Memcpy")
            and not e["name"].startswith("Memset"))
    return n / len(ctx.traced_spans)
