"""Small sizes at which the benchmark's CPU tests drive each cell: the
port's plain versions on the CPU, the cells' own schedules shrunk."""

import time

QNET = {"dqn.num_envs": 64, "dqn.rollout_length": 32,
        "dqn.updates_per_iteration": 4, "dqn.batch_size": 128,
        "dqn.memory_size": 16384, "dqn.pallas_tile_rows": 64,
        "dqn.selfplay.episodes_per_generation": 16,
        "dqn.selfplay.eval_episodes": 32, "env.max_episode_steps": 256}
DRQN = {"drqn.num_envs": 32, "drqn.rollout_length": 32,
        "drqn.updates_per_iteration": 4, "drqn.batch_size": 16,
        "drqn.min_episodes_for_training_start": 1, "drqn.ring_len": 512,
        "drqn.feature_dim": 32, "drqn.lstm_hidden_dim": 16,
        "drqn.head_hidden_dim": 16, "drqn.trace_length": 4,
        "drqn.pallas_tile_rows": 32, "drqn.max_episode_steps": 256,
        "drqn.selfplay.episodes_per_generation": 12,
        "drqn.selfplay.eval_episodes": 16}
REPLAY = {"qnet": {"dqn.updates_per_iteration": 8,
                   "dqn.selfplay.episodes_per_generation": 40},
          "drqn": {"drqn.updates_per_iteration": 8,
                   "drqn.selfplay.episodes_per_generation": 20}}
CELLS = ["qnet.ladder", "drqn.ladder", "qnet.replay_heavy",
         "drqn.replay_heavy"]
SEED = 2**33 + 12345       # more than 32 bits, as the driver's are


def overrides(cell: str) -> dict:
    family = cell.split(".")[0]
    out = dict(QNET if family == "qnet" else DRQN)
    if cell.endswith("replay_heavy"):
        out.update(REPLAY[family])
    return out


def run(cell: str, seconds: float = 0.5, trace: bool = False, **kw):
    from benchmark import harness

    return harness.run_cell(cell, SEED, seconds, trace, time.perf_counter(),
                            device="cpu", overrides=overrides(cell), **kw)
