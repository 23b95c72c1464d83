"""Kernel 1, the fused QNet actor rollout (``csrc/actor_rollout.cu``).

Operations: both seats' forwards of an env-step, 7 -> 64 -> 64 and the A
head's 3 outputs (the learner's V head is argmax-invariant and skipped),
two operations a multiply-add. Bytes: the env state in and out (13 floats
an env), the 8 statistics rows out, the learner's and the bound slot's
packed nets in (5776 floats each; every env of a fresh run plays A, so
one opponent slot is read), and in training the transitions out (17
floats an env-step: obs, next obs, action, reward, done). A gate chunk is
256 steps of at most 8192 envs with one opponent and no transitions.
Counting as ``chip_smoke.py::actor_bound_ms`` does.
"""

from benchmark.peaks import bound_s as _bound

NAME = "actor_rollout_kernel"
NET = 5776


def cost(B: int, T: int, emit: bool):
    flops = 2 * 2 * (7 * 64 + 64 * 64 + 3 * 64) * B * T
    nbytes = (2 * 13 * 4 * B + 8 * 4 * B + NET * 4 * 2
              + (68 * B * T if emit else 0))
    return flops, nbytes


def bound_s(d: dict, cfg: dict, phase: str) -> float:
    n = d["num_envs"]
    if phase == "gate":
        return _bound(*cost(min(n, 8192), 256, False))
    return _bound(*cost(n, d["rollout_length"], True))
