"""Kernel 4, the fused DRQN update block (``csrc/drqn_update.cu``), one
launch of K updates of ``bs`` trace windows of T steps.

Operations, per update: the online forward over the obs and next-obs
windows, the backward over the obs window (the next window's gradient is
zero), Adam over every parameter (12 an element), and the target's pass
over every update's next window once a block (hard target sync). Bytes:
the windows, the last-step fields and the noise in, the four parameter
vectors in and out, the losses out. Counting as
``chip_smoke.py::drqn_update_bound_ms`` does, with no target sync inside
the block.
"""

from benchmark.peaks import bound_s as _bound

NAME = "drqn_update_kernel"


def n_params(d: dict) -> int:
    F1, F, H, HH = (d["feature_dim"] // 2, d["feature_dim"],
                    d["lstm_hidden_dim"], d["head_hidden_dim"])
    feats = 7 * F1 + F1 + F1 * F + F
    lstm = F * 4 * H + H * 4 * H + 8 * H
    heads = 2 * (H * HH + HH) + 2 * (HH + 1) + 2 * (3 * HH + 3)
    return feats + lstm + heads


def n_noise(d: dict) -> int:
    H, HH = d["lstm_hidden_dim"], d["head_hidden_dim"]
    return H * HH + HH + HH + 1 + 3 * HH + 3


def cost(d: dict):
    F1, F, H, HH = (d["feature_dim"] // 2, d["feature_dim"],
                    d["lstm_hidden_dim"], d["head_hidden_dim"])
    K, bs, T = d["updates_per_iteration"], d["batch_size"], \
        d["trace_length"]
    P = n_params(d)
    N, NB = T * 2 * bs, T * bs
    fwd = (2 * (7 * F1 + F1 * F + F * 4 * H + H * 4 * H) * N + 10 * H * N
           + 2 * (H * HH + 4 * HH) * 2 * bs)
    bwd = (2 * (2 * H * HH + 4 * HH) * bs + (T - 1) * 2 * 4 * H * H * bs
           + 2 * (H * 4 * H + 2 * F * 4 * H + 2 * F1 * F + 7 * F1) * NB
           + 20 * H * NB)
    tpass = 2 * (7 * F1 + F1 * F + F * 4 * H + H * 4 * H) * T \
        + 2 * (H * HH + 4 * HH)
    wide = 0 if d["target_tau"] > 0 else K * bs * tpass
    flops = K * (fwd + bwd + 12 * P) + wide
    nbytes = 4 * (K * 7 * T * 2 * bs + T * 7 * K * bs + K * 4 * bs
                  + K * n_noise(d) + 8 * P + K)
    return flops, nbytes


def bound_s(d: dict, cfg: dict, phase: str) -> float:
    return _bound(*cost(d))
