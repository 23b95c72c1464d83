"""Kernel 2, the fused PER + Double-DQN update block
(``csrc/dqn_update.cu``), one launch of K updates of ``bs``.

Operations, per update: three forwards of a sample (online on obs and
next obs, target on next obs), the heads' backward and, unless heads
only, the trunk's, the two-level sampler (a compare per chunk and per
slot of the chunk), Adam over the 5192 parameters. Bytes: the uniforms
and noise in, parameters, target and both moments in and out, the chunk
sums in, and per touched chunk its 128 priorities, per touched slot its
16 fields and its priority, the emitted priorities and indices and the
losses. Every sampled slot is counted as touched once; the touched chunks
are the expected number of distinct ones among ``K bs`` draws. Counting
as ``tools/dqn_roofline_bench.py::update_accounting`` does.
"""

from benchmark.peaks import bound_s as _bound

NAME = "dqn_update_kernel"
PARAMS = 5192
NOISE = 260


def cost(bs: int, K: int, nc: int, heads_only: bool):
    fwd = 2 * (7 * 64 + 64 * 64) + 2 * 4 * 64
    flops = 3 * bs * fwd + 2 * bs * 4 * 64 + nc + bs * 128
    if not heads_only:
        flops += bs * 2 * (4 * 64 + 2 * 64 * 64 + 7 * 64)
    flops = (flops + 12 * PARAMS) * K
    slots = K * bs
    chunks = nc * (1.0 - (1.0 - 1.0 / nc) ** slots)
    nbytes = (4 * K * bs + 4 * K * NOISE + 8 * 4 * PARAMS + 4 * nc
              + 512 * chunks + 64 * slots + 4 * slots + 4 * chunks
              + 8 * K * bs + 4 * K)
    return flops, nbytes


def bound_s(d: dict, cfg: dict, phase: str) -> float:
    return _bound(*cost(d["batch_size"], d["updates_per_iteration"],
                        d["memory_size"] // 128, d["train_heads_only"]))
