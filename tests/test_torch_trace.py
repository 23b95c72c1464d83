"""PyTorch port: the program's tracer (``utils/trace.py``) and its spans.

Off it records nothing and enters no ``record_function``; on it nests,
sets parents and tries, counts, bounds its records, and ``readback``
returns what the read it replaces returns. Tiny QNet and DRQN loops (the
benchmark's CPU sizes) traced: the span tree of every try, the gates'
counters, and states, metrics and win rates bit-identical to a run with
tracing off from the same seed. ``cli train --trace`` logs a ``spans``
record at each gate."""

import dataclasses
import json
import os
import threading

import pytest
import torch

from benchmark.tests.tiny import DRQN as TINY_DRQN
from benchmark.tests.tiny import QNET as TINY_QNET
from pingpong_tpu_torch.config import apply_overrides, load_config
from pingpong_tpu_torch.ops import build
from pingpong_tpu_torch.selfplay.loop import QNetSelfPlay
from pingpong_tpu_torch.selfplay.loop_rnn import DRQNSelfPlay
from pingpong_tpu_torch.utils import trace
from pingpong_tpu_torch.utils.metrics import MetricsLogger

PROGRAM = ("loop::", "learner::", "replay::", "gate::", "sync::", "ops::",
           "mesh::")


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with tracing off and nothing kept."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def by_id(spans):
    return {s["id"]: s for s in spans}


def children(spans, parent, name=None):
    return [s for s in spans if s["parent"] == parent["id"]
            and (name is None or s["name"] == name)]


# ---------------------------------------------------------------------------
# The tracer alone
# ---------------------------------------------------------------------------

def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = trace.span("x"), trace.span("y", try_id=(1, 1))
    assert a is b                       # one shared no-op
    with torch.profiler.profile() as prof:
        with a:
            with b:
                trace.count("c", 3)
                assert trace.readback(torch.arange(3)) == [0, 1, 2]
        torch.ones(2).sum()
    out = trace.drain()
    assert out["spans"] == [] and out["counters"] == {}
    assert out["dropped"] == 0
    assert not [e for e in prof.events() if e.name.startswith(PROGRAM)]


def test_on_nests_sets_parents_tries_and_counts():
    trace.enable()
    with trace.span("loop::try", try_id=(3, 2)):
        with trace.span("learner::iteration"):
            with trace.span("learner::rollout"):
                trace.count("gate::chunks")
                trace.count("gate::env_steps", 64)
        with trace.span("loop::gate"):
            pass
    with trace.span("loop::autosave"):
        trace.count("gate::env_steps", 16)
    out = trace.drain()
    spans = out["spans"]
    names = [s["name"] for s in spans]          # recorded as they close
    assert names == ["learner::rollout", "learner::iteration", "loop::gate",
                     "loop::try", "loop::autosave"]
    ids = {s["name"]: s for s in spans}
    assert ids["loop::try"]["parent"] is None
    assert ids["learner::iteration"]["parent"] == ids["loop::try"]["id"]
    assert ids["learner::rollout"]["parent"] == ids["learner::iteration"]["id"]
    assert ids["loop::gate"]["parent"] == ids["loop::try"]["id"]
    assert ids["loop::autosave"]["parent"] is None
    for n in ("loop::try", "learner::iteration", "learner::rollout",
              "loop::gate"):
        assert ids[n]["try_id"] == (3, 2)
    assert ids["loop::autosave"]["try_id"] is None
    for s in spans:
        assert 0 < s["t0_ns"] <= s["t1_ns"]
    inner, outer = ids["learner::rollout"], ids["loop::try"]
    assert outer["t0_ns"] <= inner["t0_ns"] <= inner["t1_ns"] \
        <= outer["t1_ns"]
    assert out["counters"] == {"gate::chunks": 1, "gate::env_steps": 80}
    assert trace.drain()["spans"] == []         # drained


def test_records_are_bounded_and_the_rest_counted(monkeypatch):
    monkeypatch.setattr(trace._TRACER, "max_records", 5)
    trace.enable()
    for _ in range(8):
        with trace.span("learner::iteration"):
            pass
    trace.count("sync::readbacks", 2)
    out = trace.drain()
    assert len(out["spans"]) == 5 and out["dropped"] == 3
    assert out["counters"] == {"sync::readbacks": 2}
    with trace.span("learner::iteration"):
        pass
    out = trace.drain()
    assert len(out["spans"]) == 1 and out["dropped"] == 0


@pytest.mark.parametrize("on", [False, True])
def test_readback_returns_the_read_it_replaces(on):
    if on:
        trace.enable()
    x = torch.tensor([3, 1, 4], dtype=torch.int32)
    f = torch.tensor(2.5, dtype=torch.float32) / 3
    cases = [(x, None, x.tolist()), (f, float, float(f)),
             (x.sum(), int, int(x.sum())), (f, None, f.tolist()),
             (torch.tensor(True), bool, True)]
    for t, read, want in cases:
        got = trace.readback(t) if read is None else trace.readback(t, read)
        assert got == want and type(got) is type(want)
    out = trace.drain()
    n = len(cases) if on else 0
    assert [s["name"] for s in out["spans"]] == ["sync::readback"] * n
    assert out["counters"].get("sync::readbacks", 0) == n


def test_spans_reach_the_profiler_only_when_on():
    trace.enable()
    with torch.profiler.profile() as prof:
        with trace.span("learner::iteration"):
            with trace.span("replay::push"):
                torch.ones(4).cumsum(0)
    names = {e.name for e in prof.events()}
    assert {"learner::iteration", "replay::push"} <= names
    # outside a profile no record_function is entered, but records are kept
    with trace.span("learner::rollout"):
        pass
    assert [s["name"] for s in trace.drain()["spans"]] == [
        "replay::push", "learner::iteration", "learner::rollout"]


def test_timed_span_reads_the_clock_either_way():
    with trace.timed_span("loop::gate") as off:
        torch.ones(8).sum()
    assert off.seconds >= 0.0 and trace.drain()["spans"] == []
    trace.enable()
    with trace.timed_span("loop::gate") as on:
        pass
    (rec,) = trace.drain()["spans"]
    assert rec["name"] == "loop::gate"
    assert on.seconds == (rec["t1_ns"] - rec["t0_ns"]) * 1e-9


def test_each_thread_nests_its_own_spans():
    trace.enable()
    seen = []

    def worker():
        with trace.span("ops::build"):
            seen.append(True)

    with trace.span("loop::try", try_id=(1, 1)):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen
    spans = {s["name"]: s for s in trace.drain()["spans"]}
    assert spans["ops::build"]["parent"] is None
    assert spans["ops::build"]["try_id"] is None


def test_summarize_gives_count_total_and_self_time():
    drained = dict(spans=[
        dict(id=2, parent=1, name="learner::rollout", t0_ns=10, t1_ns=40,
             try_id=(1, 1)),
        dict(id=3, parent=1, name="learner::update", t0_ns=40, t1_ns=90,
             try_id=(1, 1)),
        dict(id=1, parent=None, name="learner::iteration", t0_ns=0,
             t1_ns=100, try_id=(1, 1)),
        dict(id=5, parent=4, name="learner::rollout", t0_ns=110, t1_ns=130,
             try_id=(1, 1)),
        dict(id=4, parent=None, name="learner::iteration", t0_ns=100,
             t1_ns=140, try_id=(1, 1))],
        counters={"sync::readbacks": 4}, dropped=0,
        kernel_launches={"actor_rollout": 7})
    out = trace.summarize(drained)
    it = out["spans"]["learner::iteration"]
    assert it["count"] == 2
    assert it["total_s"] == pytest.approx(140e-9)
    assert it["self_s"] == pytest.approx((100 - 80 + 40 - 20) * 1e-9)
    ro = out["spans"]["learner::rollout"]
    assert ro["count"] == 2 and ro["self_s"] == pytest.approx(50e-9)
    assert out["counters"] == {"sync::readbacks": 4}
    assert out["kernel_launches"] == {"actor_rollout": 7}
    json.dumps(out)


def test_drain_reports_kernel_launches_without_counting_them(monkeypatch):
    monkeypatch.setattr(build, "_KERNELS", [])
    k = build.CudaKernel("actor_rollout", "sym", [])
    k2 = build.CudaKernel("actor_rollout", "sym", [])
    k.launches, k2.launches = 5, 2
    trace.enable()
    out = trace.drain()
    assert out["kernel_launches"] == {"actor_rollout": 7}
    assert "actor_rollout" not in out["counters"]


def test_a_build_that_ran_is_a_span_and_counted(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_KERNELS", [])
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    k = build.CudaKernel("x", "sym", [])

    class Done:
        returncode = 0

        def communicate(self):
            return "ptxas info: 0 bytes spill", None

    tmp = k.library.with_name(k.library.name + f".tmp-{os.getpid()}")
    trace.enable()
    k.finish_build(None)                       # nothing to build
    tmp.write_bytes(b"")
    k.finish_build(Done())
    out = trace.drain()
    assert [s["name"] for s in out["spans"]] == ["ops::build"]
    assert out["counters"] == {"ops::builds": 1}
    assert k.library.exists() and "spill" in k.ptxas_log()


@pytest.mark.parametrize("on", [False, True])
def test_mesh_collectives_follow_the_switch(on):
    import torch.distributed as dist

    from pingpong_tpu_torch.parallel.mesh import (
        Mesh,
        all_gather_cat,
        all_reduce_,
        broadcast_,
        free_port,
    )

    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = Mesh(shape={"data": 1, "model": 1})
        if on:
            trace.enable()
        x = torch.arange(4.0)
        assert torch.equal(all_reduce_(x.clone(), mesh), x)
        assert torch.equal(all_gather_cat(x, mesh), x)
        assert torch.equal(broadcast_(x.clone(), mesh), x)
    finally:
        dist.destroy_process_group()
    names = [s["name"] for s in trace.drain()["spans"]]
    assert names == (["mesh::all_reduce", "mesh::all_gather",
                      "mesh::broadcast"] if on else [])


# ---------------------------------------------------------------------------
# Tiny loops
# ---------------------------------------------------------------------------

def tiny_cfg(family, **extra):
    sizes = dict(TINY_QNET if family == "qnet" else TINY_DRQN)
    sizes.update(extra)
    path = "configs/qnet.yaml" if family == "qnet" else "configs/rnn.yaml"
    return apply_overrides(load_config(path),
                           [f"{k}={v}" for k, v in sizes.items()])


def run_loop(family, tmp_path, seed=5, **extra):
    """A tiny loop's run on the CPU: ``(loop, events, updates a call)``."""
    cfg = tiny_cfg(family, **extra)
    logger = MetricsLogger(echo=False)
    events = []
    logger.log = lambda record: events.append(dict(record))
    cls, section = ((QNetSelfPlay, cfg.dqn) if family == "qnet"
                    else (DRQNSelfPlay, cfg.drqn))
    loop = cls(cfg.env, section, workdir=str(tmp_path), seed=seed,
               logger=logger, device="cpu")
    inner = loop.learner.train_iteration
    updates = []

    def counted(state, opp, pool_size, **kw):
        state, m = inner(state, opp, pool_size, **kw)
        updates.append(m.updates_run)
        return state, m

    loop.learner.train_iteration = counted
    loop.run()
    return loop, events, updates


SCHEDULES = {
    # gen 1 faults after two tries, gen 2 likewise: checkpoint and reset
    "qnet": {"dqn.selfplay.max_generations": 2,
             "dqn.selfplay.max_retries_for_generation": 2,
             "dqn.selfplay.curr_win_threshold": 1.1,
             "dqn.selfplay.pool_win_threshold": 1.1},
    # every generation promoted: the runtime pool grows by one a gate
    "drqn": {"drqn.selfplay.max_generations": 3,
             "drqn.selfplay.curr_win_threshold": 0.0,
             "drqn.selfplay.pool_win_threshold": 0.0},
}


def snapshot(x):
    if isinstance(x, torch.Generator):
        return x.get_state()
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if dataclasses.is_dataclass(x):
        return {f.name: snapshot(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, tuple) and hasattr(x, "_asdict"):
        return {k: snapshot(v) for k, v in x._asdict().items()}
    return x


def assert_same(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


TIMES = ("eval_s", "env_steps_per_s")


@pytest.mark.parametrize("family", ["qnet", "drqn"])
def test_traced_loop_span_tree_and_bit_identical_run(family, tmp_path):
    base, base_events, base_updates = run_loop(
        family, tmp_path / "off", **SCHEDULES[family])
    assert trace.drain()["spans"] == []         # off: nothing recorded
    trace.enable()
    loop, events, updates = run_loop(family, tmp_path / "on",
                                     **SCHEDULES[family])
    out = trace.drain()
    spans, counters = out["spans"], out["counters"]
    assert out["dropped"] == 0

    # bit-identical: train state, loop generator, metrics and win rates
    assert_same(snapshot(base.state), snapshot(loop.state))
    assert torch.equal(base.gen.get_state(), loop.gen.get_state())
    strip = lambda evs: [{k: v for k, v in e.items()
                          if k not in TIMES and k != "checkpoint"}
                         for e in evs]
    assert strip(base_events) == strip(events)
    assert updates == base_updates
    assert [(r.generation, r.promoted, r.tries, r.win_vs_a, r.win_vs_pool,
             r.episodes) for r in base.records] == [
        (r.generation, r.promoted, r.tries, r.win_vs_a, r.win_vs_pool,
         r.episodes) for r in loop.records]
    assert base.reward_history == loop.reward_history

    # one loop::try a try, marked with its (generation, try)
    tries = [s for s in spans if s["name"] == "loop::try"]
    want = [(e["generation"], e["try"]) for e in events
            if e["event"] == "try"]
    assert [s["try_id"] for s in tries] == want
    evals = [e for e in events if e["event"] == "eval"]
    last_try = {s["try_id"][0]: s["try_id"] for s in tries}
    decision = {e["generation"]: e["event"] for e in events
                if e["event"] in ("promoted", "fault")}
    assert decision                              # each schedule decides
    pool = 0
    for t, ev in zip(tries, evals):
        kids = [s["name"] for s in children(spans, t)]
        assert kids[:3] == ["loop::opponents", "loop::train_block",
                            "loop::gate"]
        (gate,) = children(spans, t, "loop::gate")
        # eval_s is the gate span's own length
        assert ev["eval_s"] == (gate["t1_ns"] - gate["t0_ns"]) * 1e-9
        n_opp = 1 + (pool if family == "drqn" else len(loop.pool))
        assert len(children(spans, gate, "gate::opponent")) == n_opp
        gen = t["try_id"][0]
        if t["try_id"] == last_try[gen] and gen in decision:
            assert "loop::checkpoint" in kids
            assert ("loop::reset" in kids) == (decision[gen] == "fault")
            if decision[gen] == "promoted":
                pool = min(pool + 1, loop.cfg.pool_max)
        else:
            assert "loop::checkpoint" not in kids
        for s in spans:
            if s["try_id"] == t["try_id"]:
                assert t["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= t["t1_ns"]

    # every train_iteration call: rollout, push, draws (the QNet kernel
    # route's draws first, before kernel 1); an update when ran
    iters = [s for s in spans if s["name"] == "learner::iteration"]
    assert len(iters) == len(updates) > 0
    ids = by_id(spans)
    first = {"qnet": ["learner::draws", "learner::rollout", "replay::push"],
             "drqn": ["learner::rollout", "replay::push", "learner::draws"]}
    for it, n_ran in zip(iters, updates):
        assert ids[it["parent"]]["name"] == "loop::train_block"
        kids = [s["name"] for s in children(spans, it)]
        assert kids[:3] == first[family]
        assert kids.count("learner::update") == (1 if n_ran else 0)
    sample = "replay::sample" if family == "drqn" else "replay::priorities"
    assert any(s["name"] == sample for s in spans)

    # the reads and the gates' counters
    reads = [s for s in spans if s["name"] == "sync::readback"]
    assert counters["sync::readbacks"] == len(reads) > 0
    assert all(s["parent"] is not None for s in reads)
    assert counters["gate::env_steps"] > 0
    assert counters["gate::chunks"] >= len(
        [s for s in spans if s["name"] == "gate::opponent"])
    assert counters["gate::episodes"] > 0


def test_iteration_spans_reach_the_profiler_only_with_tracing_on(tmp_path):
    cfg = tiny_cfg("qnet")
    loop = QNetSelfPlay(cfg.env, cfg.dqn, workdir=str(tmp_path), seed=1,
                        logger=MetricsLogger(echo=False), device="cpu")
    from pingpong_tpu_torch.train.dqn import stack_opponents

    stack, pool_size = stack_opponents(loop.params_a_play, loop.pool, 0)
    opp = loop.learner.prepare_opponents(stack)
    for on in (False, True):
        if on:
            trace.enable()
        with torch.profiler.profile() as prof:
            loop.state, _ = loop.learner.train_iteration(loop.state, opp,
                                                         pool_size)
        names = {e.name for e in prof.events()}
        program = {n for n in names if n.startswith(PROGRAM)}
        if on:
            assert {"learner::iteration", "learner::rollout", "replay::push",
                    "learner::draws", "learner::update",
                    "sync::readback"} <= program
        else:
            assert program == set()


def test_cli_train_trace_logs_spans_at_each_gate(tmp_path):
    from pingpong_tpu_torch import cli

    sizes = dict(TINY_QNET)
    sizes.update({"dqn.selfplay.max_generations": 1,
                  "dqn.selfplay.max_retries_for_generation": 2,
                  "dqn.selfplay.curr_win_threshold": 1.1,
                  "dqn.selfplay.pool_win_threshold": 1.1})
    rc = cli.main(["train", "--device", "cpu", "--trace", "--config",
                   "configs/qnet.yaml", "--workdir", str(tmp_path),
                   *[f"{k}={v}" for k, v in sizes.items()]])
    assert rc == 0
    lines = [json.loads(x) for x in
             (tmp_path / "train_qnet_metrics.jsonl").read_text().splitlines()]
    spans = [r for r in lines if r["event"] == "spans"]
    gates = [r for r in lines if r["event"] == "eval"]
    assert [(r["generation"], r["try"]) for r in spans] == [(1, 1), (1, 2)]
    assert len(spans) == len(gates)
    for rec, gate in zip(spans, gates):
        s = rec["spans"]
        assert s["loop::try"]["count"] == 1
        assert s["loop::gate"]["total_s"] == pytest.approx(gate["eval_s"])
        assert 0 <= s["loop::try"]["self_s"] <= s["loop::try"]["total_s"]
        assert s["learner::iteration"]["count"] >= 1
        assert rec["counters"]["gate::env_steps"] > 0
        assert rec["counters"]["sync::readbacks"] == \
            s["sync::readback"]["count"]
        assert rec["dropped"] == 0
    assert "loop::reset" in spans[-1]["spans"]
    # drained at each gate: nothing left of the tries
    left = [s["name"] for s in trace.drain()["spans"]]
    assert "loop::try" not in left
