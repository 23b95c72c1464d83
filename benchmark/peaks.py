"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): the rates the rooflines and ``step_mfu``
are read against. The configurations compute in float32 on the CUDA
cores, so the float32 rate without tensor cores is the one that applies.
"""

F32_FLOPS = 67e12       # float32 FLOP/s, no tensor cores
HBM_BYTES = 3.35e12     # HBM3 bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time for ``flops`` operations and ``nbytes`` bytes."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES)
