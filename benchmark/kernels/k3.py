"""Kernel 3, the fused recurrent rollout (``csrc/recurrent_rollout.cu``).

Operations: two recurrent forwards an env-step (the learner's and the
bound opponent's): the feature MLP 7 -> F/2 -> F, the LSTM's gate product
(F + H) x 4H, the cell (10 H), the shared head H x HH and the A head, and
the tile's noisy head weights once a step. Bytes: the env state and both
LSTM streams in and out, the statistics out, the learner, its sigmas and
the bound slot's net in once, and in training the transitions out (10
floats an env-step). A gate chunk is 256 steps of at most 4096 envs with
no transitions. Counting as ``chip_smoke.py::rnn_bound_ms`` does.
"""

from benchmark.peaks import bound_s as _bound

NAME = "recurrent_rollout_kernel"


def cost(d: dict, B: int, T: int, tiles: int, emit: bool):
    F1, F, H, HH = (d["feature_dim"] // 2, d["feature_dim"],
                    d["lstm_hidden_dim"], d["head_hidden_dim"])
    per_net = (2 * (7 * F1 + F1 * F + (F + H) * 4 * H + H * HH + HH * 3)
               + 10 * H)
    flops = 2 * per_net * B * T + 3 * (H * HH + 3 * HH) * tiles * T
    net = F1 * 9 + F1 * F + F + (F + H) * 4 * H + 4 * H + H * HH + HH \
        + 3 * HH + 3
    nbytes = (2 * (13 + 4 * H) * 4 * B + 8 * 4 * B
              + 4 * (net * 2 + H * HH + 4 * HH + 3)
              + (40 * B * T if emit else 0))
    return flops, nbytes


def bound_s(d: dict, cfg: dict, phase: str) -> float:
    n, tile = d["num_envs"], d["pallas_tile_rows"]
    if phase == "gate":
        b = min(n, 4096)
        return _bound(*cost(d, b, 256, b // min(tile, b), False))
    t = min(tile, n)
    return _bound(*cost(d, n, d["rollout_length"], n // t, True))
