"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``benchmark/configs/<config>.json``: the
port's full configuration as it is run, the loop that runs it and its
plain reference) and a traffic mix (``benchmark/workloads/<traffic>.json``:
the job's schedule, set as dotted keys on that configuration). The
harness builds the port's own generation loop from them with the run's
seed, on a fresh work directory under ``TMPDIR``, and drives its public
``run()``. It records spans only from its own files:

* ``Probe`` replaces the learner's ``train_iteration`` by an instance
  attribute that calls the original: it times every call, snapshots the
  state around the first calls for the reference, and opens and closes the
  measured window at call boundaries (the window ends at the first call
  after ``--seconds``, by a private exception that ``run()`` lets through);
* ``RecordingLogger`` keeps the loop's own events (``try``, ``eval`` with
  ``eval_s``, ``promoted``, ``fault``) with their host times.

Set-up (process start to the window's first call) builds the kernels, runs
the loop from the seed through its first iterations and its first gate,
and so warms every shape the window uses. After the window the program is
freed and the reference (``benchmark/reference/<reference>.py``) follows
the snapshots; every gap is held against the cell's limits
(``benchmark/limits/<cell>.json``). Per-layer metrics are read by
``benchmark/metrics/<name>.py`` from the spans, the events and, with
``--trace 1``, the profiler's device trace of the window.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from benchmark.reference.common import to_device

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pingpong_tpu")
N_CHECKED = 3       # iterations the reference follows
TRACE_SECONDS = 3.0  # the traced part of a --trace 1 window, from its start


class WindowEnd(Exception):
    """Raised by the probe at the first call after the window's length."""


# ---------------------------------------------------------------------------
# Specification
# ---------------------------------------------------------------------------

def benchmark_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def set_dotted(tree: dict, key: str, value) -> None:
    """``tree["a"]["b"] = value`` for ``key = "a.b"``; the path must
    exist, so a traffic file cannot add a key the configuration lacks."""
    *path, last = key.split(".")
    node = tree
    for k in path:
        node = node[k]
    if last not in node:
        raise KeyError(f"traffic sets {key!r}, which the configuration "
                       "does not have")
    node[last] = value


def load_cell(name: str, root: Path = ROOT,
              overrides: Optional[Dict[str, object]] = None) -> dict:
    """The cell ``name``: its entry, configuration file and traffic file,
    and the configuration with the traffic's keys (then ``overrides``, for
    the tests' small sizes) set."""
    spec = benchmark_spec(root)
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in spec["configs"]
                      if c["name"] == cell["config"])
    config = json.loads((root / conf_entry["file"]).read_text())
    traffic = json.loads(
        (BENCH / "workloads" / f"{cell['traffic']}.json").read_text())
    cfg = json.loads(json.dumps(config["config"]))
    for key, value in {**traffic["set"], **(overrides or {})}.items():
        set_dotted(cfg, key, value)
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    return dict(cell=cell, spec=spec, config=config, traffic=traffic,
                cfg=cfg, section=config["section"], limits=limits)


def metric_units(spec: dict) -> Dict[str, str]:
    return {m["name"]: m["unit"]
            for m in spec["end_to_end"] + spec["per_layer"]}


def cell_metrics(spec: dict, cell: str, kind: str) -> List[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that the
    cell reports."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


# ---------------------------------------------------------------------------
# The program's side
# ---------------------------------------------------------------------------

def snapshot(x):
    """A host copy of a train state: dataclasses and named tuples become
    dicts, tensors host tensors, generators their state."""
    if isinstance(x, torch.Generator):
        return x.get_state()
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if dataclasses.is_dataclass(x):
        return {f.name: snapshot(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, tuple) and hasattr(x, "_asdict"):
        return {k: snapshot(v) for k, v in x._asdict().items()}
    return x


def recording_logger():
    """An in-memory subclass of the program's ``MetricsLogger``, echo off:
    ``events`` holds ``(host time, record)`` and ``hooks`` are called on
    each record."""
    from pingpong_tpu_torch.utils.metrics import MetricsLogger

    class RecordingLogger(MetricsLogger):
        def __init__(self):
            super().__init__(log_path=None, echo=False)
            self.events: List[tuple] = []
            self.hooks: List[Callable] = []

        def log(self, record: dict) -> None:
            t = time.perf_counter()
            self.events.append((t, dict(record)))
            for hook in self.hooks:
                hook(t, record)

    return RecordingLogger()


def build_loop(run: dict, seed: int, workdir: str, logger, device,
               distributed: bool):
    """The configuration's loop class, built as ``cli train`` builds it."""
    from pingpong_tpu_torch.config.schema import experiment_from_dict

    exp = experiment_from_dict(run["cfg"])
    module, cls = run["config"]["loop"].split(":")
    loop_cls = getattr(importlib.import_module(module), cls)
    return loop_cls(exp.env, getattr(exp, run["section"]), workdir=workdir,
                    seed=seed, logger=logger, device=device,
                    mesh_cfg=exp.mesh if distributed else None)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Probe:
    """The instance attribute that stands in for the learner's
    ``train_iteration`` (see the module docstring)."""

    def __init__(self, loop, logger, seconds: float, profiler_factory=None,
                 agree=None, update_probe: Optional[str] = None):
        self.loop = loop
        self.learner = loop.learner
        self.inner = loop.learner.train_iteration
        self.seconds = seconds
        self.profiler_factory = profiler_factory
        self.profiler = None
        self.agree = agree or (lambda flag: flag)
        self.gather = getattr(self.learner, "gather_state", lambda s: s)
        self.phase = "setup"
        self.calls = 0
        self.first = None           # the program's state at its first call
        self.checks: List[dict] = []
        self.gate: Optional[dict] = None
        self.promoted = False
        self.gates_seen = 0
        self.last_params = None
        self.last_loop_gen = None
        self.spans: List[dict] = []
        self.t0 = self.t1 = self.trace_t1 = None
        self.update_out = None
        self._hook = None
        if update_probe:
            # the update dispatcher the learner calls, for the sampled
            # slots and per-update losses of the checked calls (set-up only)
            mod_name, attr = update_probe.split(":")
            module = importlib.import_module(mod_name)
            original = getattr(module, attr)

            def hook(*args, **kwargs):
                out = original(*args, **kwargs)
                self.update_out = [x.detach().to("cpu", copy=True)
                                   for x in out]
                return out

            setattr(module, attr, hook)
            self._hook = (module, attr, original)
        logger.hooks.append(self._on_event)
        loop.learner.train_iteration = self

    def release(self) -> None:
        """Give the program back its own functions."""
        self.loop.learner.train_iteration = self.inner
        self.unhook()

    def unhook(self) -> None:
        if self._hook is not None:
            module, attr, original = self._hook
            setattr(module, attr, original)
            self._hook = None

    def _on_event(self, t: float, record: dict) -> None:
        ev = record.get("event")
        if ev == "eval":
            self.gates_seen += 1
            if self.gate is None and not self.promoted \
                    and self.last_params is not None:
                self.gate = dict(params=self.last_params,
                                 loop_generator=self.last_loop_gen,
                                 win_vs_A=float(record["win_vs_A"]))
        elif ev == "promoted":
            self.promoted = True

    def _warm(self) -> bool:
        done = len(self.checks) >= N_CHECKED or self.promoted
        return done and self.gates_seen >= 1 and self.calls >= N_CHECKED + 1

    def __call__(self, state, opp, pool_size, **kw):
        if self.phase == "setup" and self.agree(self._warm()):
            self.unhook()
            if self.profiler_factory is not None:
                # started before the window: its start-up is set-up
                self.profiler = self.profiler_factory()
                self.profiler.__enter__()
            _sync()
            self.t0 = time.perf_counter()
            self.phase = "window"
        elif self.phase == "window":
            now = time.perf_counter()
            if self.profiler is not None and self.trace_t1 is None and \
                    self.agree(now >= self.t0 + TRACE_SECONDS):
                _sync()
                self.trace_t1 = time.perf_counter()
                self.profiler.__exit__(None, None, None)
            if self.agree(now >= self.t0 + self.seconds):
                _sync()
                self.t1 = time.perf_counter()
                if self.profiler is not None and self.trace_t1 is None:
                    self.trace_t1 = self.t1
                    self.profiler.__exit__(None, None, None)
                raise WindowEnd()
        setup = self.phase == "setup"
        check = setup and not self.promoted and len(self.checks) < N_CHECKED
        pre = snapshot(self.gather(state)) if check or self.calls == 0 \
            else None
        if self.calls == 0:
            self.first = dict(state=pre, loop_generator=self.loop.gen
                              .get_state())
        self.update_out = None
        ts = time.perf_counter()
        if self.profiler is not None and self.trace_t1 is None:
            with torch.profiler.record_function("bench::iteration"):
                state, m = self.inner(state, opp, pool_size, **kw)
        else:
            state, m = self.inner(state, opp, pool_size, **kw)
        te = time.perf_counter()
        self.calls += 1
        if check and m.updates_run > 0:
            self.checks.append(dict(pre=pre, post=snapshot(self.gather(state)),
                                    metrics=m._asdict(),
                                    update=self.update_out))
        if setup and self.gate is None:
            self.last_params = state.params.detach().to("cpu", copy=True)
            self.last_loop_gen = self.loop.gen.get_state()
        if not setup:
            self.spans.append(dict(t0=ts, t1=te, env_steps=m.env_steps,
                                   updates=m.updates_run))
        return state, m


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile ``q`` (0-100) of ``values``."""
    s = sorted(values)
    k = max(0, min(len(s) - 1, int(-(-q * len(s) // 100)) - 1))
    return s[k]


def window_events(logger, t0: float, t1: float) -> List[tuple]:
    return [(t, r) for t, r in logger.events if t0 <= t <= t1]


def rank_tiles(cfg: dict, section: str, world: int) -> dict:
    """The configuration as the reference follows a run on ``world``
    ranks: each rank rolls out its block of the envs in tiles of at most
    the block, keyed by the global tile, which is the single-device
    rollout with tiles of that size (the learners' ``_tiling``)."""
    d = cfg[section]
    block = d["num_envs"] // world
    tile = min(d["pallas_tile_rows"], block)
    if world == 1 or block % tile:
        return cfg
    out = json.loads(json.dumps(cfg))
    out[section]["pallas_tile_rows"] = tile
    return out


def reference_checks(run: dict, seed: int, probe: Probe, device,
                     mode: str = "f32", world: int = 1) -> Dict[str, float]:
    """The gaps between the program and the plain reference (``mode`` f32),
    or between the reference in ``mode`` put in the program's place and
    the reference (the control)."""
    ref = importlib.import_module(
        f"benchmark.reference.{run['config']['reference']}")
    cfg = rank_tiles(run["cfg"], run["section"], world)
    start = ref.start(cfg, seed, device)
    out = {}
    # the control starts where the reference starts
    out["start_gap"] = ref.start_gap(
        start, to_device(probe.first["state"], device),
        probe.first["loop_generator"]) if mode == "f32" else 0.0
    a_play = start["a_play"]
    steps, refs, pres = [], [], []
    for c in probe.checks:
        r = ref.follow(cfg, c["pre"], c["post"], a_play, device,
                       given=c["update"])
        if mode == "f32":
            p = ref.program_outputs(c["pre"], c["post"], c["metrics"],
                                    c["update"], device)
        else:
            p = ref.follow(cfg, c["pre"], c["post"], a_play, device,
                           given=c["update"], mode=mode)
        steps.append(p)
        refs.append(r)
        pres.append(c["pre"])
    if probe.checks:
        out.update(ref.compare(steps, refs, pres, device, cfg))
    if probe.gate is not None:
        # every rank plays the whole gate, as one device does
        r = ref.gate(run["cfg"], probe.gate, a_play, device)
        p = (probe.gate["win_vs_A"] if mode == "f32"
             else ref.gate(run["cfg"], probe.gate, a_play, device, mode))
        out["gate_gap"] = abs(p - r)
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """``(correct, failed, rows)``: every limit must have its number, and
    every number must be at most its limit."""
    rows = {}
    failed = 0
    for name, limit in limits.items():
        v = values.get(name)
        ok = v is not None and v <= limit
        failed += 0 if ok else 1
        rows[name] = {"value": v, "limit": limit}
    return failed == 0, failed, rows


def end_to_end(probe: Probe, t_proc0: float) -> Dict[str, float]:
    window = probe.t1 - probe.t0
    iters = [1e3 * (s["t1"] - s["t0"]) for s in probe.spans]
    return dict(
        train_env_steps_per_s=sum(s["env_steps"] for s in probe.spans)
        / window,
        iter_ms_p95=percentile(iters, 95.0) if iters else None,
        setup_s=probe.t0 - t_proc0)


def drive(run: dict, seed: int, seconds: float, trace: bool,
          t_proc0: float, device="cuda", distributed: bool = False,
          world: int = 1):
    """Build the loop, drive ``run()`` through set-up and the window, read
    the trace, and free the program. Returns ``(probe, logger, peak
    bytes, trace context or None)``."""
    logger = recording_logger()
    workdir = tempfile.mkdtemp(prefix="bench-run-",
                               dir=os.environ.get("TMPDIR"))
    probe = None
    agree = None
    if world > 1:
        def agree(flag: bool) -> bool:
            t = torch.tensor([int(flag)], device=device)
            torch.distributed.broadcast(t, 0)
            return bool(t.item())
    on_card = device != "cpu" and torch.cuda.is_available()
    try:
        loop = build_loop(run, seed, workdir, logger, device, distributed)
        profiler_factory = None
        if trace:
            from benchmark.trace import make_profiler
            profiler_factory = make_profiler
        probe = Probe(loop, logger, seconds, profiler_factory, agree,
                      run["config"].get("update_probe"))
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        try:
            loop.run()
            raise RuntimeError("the loop finished before the window closed: "
                               "raise max_generations")
        except WindowEnd:
            pass
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if world > 1 and on_card:
            t = torch.tensor([peak], device=device)
            torch.distributed.all_reduce(t, torch.distributed.ReduceOp.MAX)
            peak = int(t.item())
        ctx = None
        if trace:
            from benchmark.trace import Context
            ctx = Context(run, probe, window_events(logger, probe.t0,
                                                    probe.t1),
                          probe.profiler)
            probe.profiler = None
            print(f"trace: {len(ctx.kernels)} device events over "
                  f"{ctx.traced_s:.3f} s, the last ending at "
                  f"{ctx.coverage:.4f} of it; {ctx.linked_share:.4f} placed "
                  "by their launch", file=sys.stderr)
        # free the program before the reference runs
        probe.release()
        del loop
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        return probe, logger, peak, ctx
    finally:
        if probe is not None:
            probe.release()
        shutil.rmtree(workdir, ignore_errors=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_proc0: float, device="cuda", root: Path = ROOT,
             overrides=None, distributed: bool = False, rank: int = 0,
             world: int = 1) -> dict:
    """One run: set-up, the window, the reference; returns the result
    line's fields (rank 0's, under a mesh)."""
    run = load_cell(name, root, overrides)
    spec = run["spec"]
    probe, logger, peak, ctx = drive(run, seed, seconds, trace, t_proc0,
                                     device, distributed, world)
    if rank != 0:
        return {}
    units = metric_units(spec)
    if trace:
        metrics = {}
        for m in cell_metrics(spec, name, "per_layer"):
            reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        e2e = end_to_end(probe, t_proc0)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(spec, name, "end_to_end")}
    values = reference_checks(run, seed, probe, device, world=world)
    correct, failed, rows = judge(values, run["limits"])
    dev = device_info(device, world, peak)
    result = dict(correct=correct, attempted=len(probe.spans),
                  failed=failed, metrics=metrics, device=dev)
    if trace:
        dev["busy_s"] = ctx.busy_s
        dev["window_s"] = ctx.traced_s
        result["breakdown"] = ctx.breakdown()
    result["checks"] = rows
    return result


def device_info(device, world: int, peak: int) -> dict:
    if device == "cpu" or not torch.cuda.is_available():
        return dict(platform="cpu", kind="cpu", count=world,
                    memory_peak_bytes=peak)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=world, memory_peak_bytes=int(peak))


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
