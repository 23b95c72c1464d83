"""PyTorch port: the generation loop both agent families run
(``selfplay/generations.py``).

Neither family's loop redefines a method of the base: each gives only the
base's abstract decisions. A tiny run of each family, with a promotion, a
fault, autosaves, a restore and retention, logs every event kind with the
keys in the order the CLI's plots and the benchmark's harness read them
(the ``mesh`` event needs more than one rank: ``test_torch_distributed``).
The recurrent gate after a promotion plays the promoted A: the benchmark's
frozen recurrent gate, from the same generator state, gives the same win
rate (the QNet twin is in ``test_torch_gate_packs``)."""

import dataclasses
import inspect

import pytest
import torch

from benchmark.reference.frozen import env as frozen_env
from benchmark.reference.frozen import gates as frozen_gates
from benchmark.reference.frozen import qnet_rnn as frozen_qnet_rnn
from benchmark.tests.tiny import DRQN as TINY_DRQN
from benchmark.tests.tiny import QNET as TINY_QNET
from pingpong_tpu_torch.config import apply_overrides, load_config
from pingpong_tpu_torch.models.qnet_rnn import qnet_rnn_to_flat
from pingpong_tpu_torch.selfplay.generations import SelfPlayLoop
from pingpong_tpu_torch.selfplay.loop import QNetSelfPlay
from pingpong_tpu_torch.selfplay.loop_rnn import DRQNSelfPlay
from pingpong_tpu_torch.utils import trace
from pingpong_tpu_torch.utils.metrics import MetricsLogger

FAMILIES = {"qnet": (QNetSelfPlay, "configs/qnet.yaml", "dqn", TINY_QNET),
            "drqn": (DRQNSelfPlay, "configs/rnn.yaml", "drqn", TINY_DRQN)}

SPANS = ["event", "generation", "try", "spans", "counters", "dropped",
         "kernel_launches"]
COMMON = {
    "try": ["event", "generation", "try"],
    "autosave": ["event", "train_steps"],
    "eval_seats": ["event", "win_as_b", "win_as_a"],
    "promoted": ["event", "generation", "checkpoint"],
    "fault": ["event", "generation", "checkpoint"],
    "retention": ["event", "deleted"],
    "spans": SPANS,
}
INTERVAL = ["event", "episode", "win_vs_A", "win_vs_pool", "epsilon", "loss",
            "env_steps_per_s"]
KEYS = {
    "qnet": {**COMMON, "interval": INTERVAL + ["buffer"],
             "eval": ["event", "generation", "win_vs_A", "win_vs_pool",
                      "epsilon", "eval_s"]},
    "drqn": {**COMMON, "interval": INTERVAL + ["buffer_episodes"],
             "eval": ["event", "generation", "win_vs_A", "win_vs_pool",
                      "eval_s"]},
}
# the start-up's restore events: the first run's, then the resumed run's
RESTORES = {"qnet": [[], [("restore", 0, True)]],
            "drqn": [[("restore", 3, False)], [("restore", 1, True)]]}


@pytest.fixture(autouse=True)
def tracer_off_one_thread():
    """Tracing off; the tiny loops' host operators on one thread (more
    only spin on these shapes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()
    torch.set_num_threads(threads)


def tiny_loop(kind, workdir, logger, **selfplay):
    cls, path, section, tiny = FAMILIES[kind]
    cfg = apply_overrides(load_config(path), [
        f"{k}={v}" for k, v in {
            **tiny, f"{section}.selfplay.max_retries_for_generation": 1,
            f"{section}.selfplay.win_rate_interval": 8,
            f"{section}.selfplay.pool_win_threshold": 0.0,
            f"{section}.keep_checkpoints": 1,
            f"{section}.save_latest_checkpoint_interval_steps": 4,
            **{f"{section}.selfplay.{k}": v
               for k, v in selfplay.items()}}.items()])
    return cls(cfg.env, getattr(cfg, section), workdir=str(workdir), seed=5,
               logger=logger, device="cpu", log_spans=True)


class Events(MetricsLogger):
    """The logged records; after the first promotion the loop's
    threshold rises out of reach, so the next generation faults."""

    def __init__(self):
        super().__init__(echo=False)
        self.records, self.loop = [], None

    def log(self, record):
        self.records.append(dict(record))
        if record["event"] == "promoted" and self.loop is not None:
            cfg = self.loop.cfg
            self.loop.cfg = dataclasses.replace(cfg, selfplay=dataclasses
                                                .replace(cfg.selfplay,
                                                         curr_win_threshold=2))
            self.loop = None


@pytest.mark.parametrize("kind", ["qnet", "drqn"])
def test_a_family_gives_only_decisions_and_logs_the_events(kind, tmp_path):
    cls = FAMILIES[kind][0]
    hooks = SelfPlayLoop.__abstractmethods__
    assert not cls.__abstractmethods__
    for name, member in vars(SelfPlayLoop).items():
        if inspect.isfunction(member) and name not in hooks:
            assert name not in vars(cls), f"{cls.__name__} redefines {name}"
    assert set(hooks) <= set(vars(cls))

    # generation 1 promotes, 2 faults (one try); the resumed run restores
    # the final autosave, gates side-balanced and promotes 3, and retention
    # drops model 1
    runs = []
    for generations in (2, 3):
        log = Events()
        loop = tiny_loop(kind, tmp_path, log, max_generations=generations,
                         curr_win_threshold=0.0,
                         swap_sides_eval=generations == 3)
        log.loop = loop
        loop.run()
        runs.append(log.records)
    first, resumed = runs
    decisions = [(e["event"], e["generation"]) for e in first + resumed
                 if e["event"] in ("promoted", "fault")]
    assert decisions == [("promoted", 1), ("fault", 2), ("promoted", 3)]
    for run, want in zip(runs, RESTORES[kind]):
        assert [(e["event"], e["tier"], "path" in e) for e in run
                if e["event"].startswith("restore")] == want
    assert {e["event"] for e in first + resumed} == (
        set(KEYS[kind]) | {"restore"})
    for e in first + resumed:
        if e["event"] != "restore":
            assert list(e) == KEYS[kind][e["event"]], e["event"]


def test_drqn_gate_after_a_promotion_equals_the_frozen_gate(tmp_path):
    """The first gate after a promotion, replayed by the benchmark's
    frozen recurrent gate from the loop generator's state before it."""
    log = MetricsLogger(echo=False)
    loop = tiny_loop("drqn", tmp_path, log, max_generations=2,
                     curr_win_threshold=0.0)
    gates, before = [], {}
    inner = loop.learner.train_iteration

    def call(state, opp, pool_size, **kw):
        state, m = inner(state, opp, pool_size, **kw)
        before.update(gen=loop.gen.get_state(), params=state.params.clone())
        return state, m

    def record(rec, real=log.log):
        real(rec)
        if rec["event"] == "eval":
            gates.append(dict(before, a=loop.params_a, pool=len(loop.pool),
                              win=rec["win_vs_A"]))

    loop.learner.train_iteration = call
    log.log = record
    assert [r.promoted for r in loop.run()] == [True, True]
    g = gates[1]
    # it plays the promoted A, which the pool took on as well
    assert g["pool"] == 1
    assert torch.equal(qnet_rnn_to_flat(g["a"]), gates[0]["params"])
    cfg = loop.cfg
    like = frozen_qnet_rnn.qnet_rnn_init(
        torch.Generator().manual_seed(0), feature_dim=cfg.feature_dim,
        lstm_hidden_dim=cfg.lstm_hidden_dim,
        head_hidden_dim=cfg.head_hidden_dim)
    gen = torch.Generator()
    gen.set_state(g["gen"])
    n = cfg.num_envs
    want, _ = frozen_gates.rnn_win_rate(
        frozen_env.env_params_from_config(loop.env_cfg),
        frozen_qnet_rnn.qnet_rnn_from_flat(qnet_rnn_to_flat(g["a"]), like),
        frozen_qnet_rnn.qnet_rnn_from_flat(g["params"], like), gen,
        min_episodes=max(2, cfg.selfplay.eval_episodes), n_envs=min(n, 4096),
        tile_rows=min(cfg.pallas_tile_rows, n),
        max_episode_steps=cfg.max_episode_steps, device="cpu")
    assert g["win"] == want
