"""The traced window: ``torch.profiler`` over the window of a ``--trace 1``
run, and what the per-layer readers take from it.

The profiler's events carry their own clock. The probe marks every
``train_iteration`` call with a ``bench::iteration`` annotation, whose
host start is also known, so the median offset between the two clocks
places the window and the gates (known only on the host, from the loop's
``eval`` events) on the trace's clock. A device event belongs to the host
interval (iteration, gate, or the loop's glue between them) in which it was
launched: the runtime call's time where the trace links the two by
correlation id, else the device event's own start.
"""

from __future__ import annotations

import bisect
import importlib
import statistics
from typing import Dict, List, Optional, Tuple

import torch

ITERATION = "bench::iteration"


def make_profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def _is_device(e) -> bool:
    return e.device_type() != torch.autograd.DeviceType.CPU


def _is_activity(e) -> bool:
    """A kernel, copy or set on the device (not an annotation's mirror)."""
    if not _is_device(e) or e.name() == ITERATION:
        return False
    return not getattr(e, "is_user_annotation", lambda: False)()


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Context:
    """What a per-layer reader gets: the cell's run (``cfg``, ``section``),
    the window's host spans and loop events, and (traced runs) the device
    events with their phase, the device's busy time and the breakdown."""

    def __init__(self, run: dict, probe, events: List[tuple], profiler):
        self.run = run
        self.cfg = run["cfg"]
        self.section = run["section"]
        self.d = self.cfg[self.section]
        self.spans = probe.spans
        self.t0, self.t1 = probe.t0, probe.t1
        # the traced part of the window, from its start
        self.trace_t1 = probe.trace_t1 or probe.t1
        self.traced_spans = [s for s in self.spans if s["t1"] <= self.trace_t1]
        self.events = events
        self.gates = [(t - r["eval_s"], t) for t, r in events
                      if r.get("event") == "eval"]
        self.eval_s = [r["eval_s"] for _, r in events
                       if r.get("event") == "eval"]
        self.tries = sum(1 for _, r in events if r.get("event") == "try")
        self.window_s = self.t1 - self.t0
        self.traced_s = self.trace_t1 - self.t0
        self.kernels: List[dict] = []   # name, dur_s, phase
        self.busy_s = 0.0
        self._gaps: List[Tuple[float, str]] = []
        self.linked_share = 0.0
        self.coverage = 0.0
        if profiler is not None:
            self._read(profiler)

    # -- the device trace ----------------------------------------------------
    def _read(self, profiler) -> None:
        events = list(profiler.profiler.kineto_results.events())
        ann = sorted((e.start_ns(), e.end_ns()) for e in events
                     if e.name() == ITERATION and not _is_device(e))
        host = sorted((s["t0"], s["t1"]) for s in self.traced_spans)
        n = min(len(ann), len(host))
        off = statistics.median(ann[i][0] - host[i][0] * 1e9
                                for i in range(n)) if n else 0.0
        to_ns = lambda t: t * 1e9 + off
        w0, w1 = to_ns(self.t0), to_ns(self.trace_t1)
        gates = sorted((to_ns(a), to_ns(b)) for a, b in self.gates)
        launch = {e.correlation_id(): e.start_ns() for e in events
                  if not _is_device(e) and e.name().startswith("cu")}
        dev = [e for e in events if _is_activity(e)
               and w0 <= e.start_ns() <= w1]
        self.coverage = ((max(e.end_ns() for e in dev) - w0) / (w1 - w0)
                         if dev else 0.0)
        starts_i = [a for a, _ in ann]
        starts_g = [a for a, _ in gates]

        def inside(t, starts, spans):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= spans[i][1]

        def phase(t) -> str:
            if inside(t, starts_i, ann):
                return "iteration"
            if inside(t, starts_g, gates):
                return "gate"
            return "loop"

        linked = 0
        intervals = []
        for e in dev:
            t = launch.get(e.correlation_id())
            if t is None:
                t = launch.get(e.linked_correlation_id())
            if t is None:
                t = e.start_ns()
            else:
                linked += 1
            a, b = e.start_ns(), min(e.end_ns(), int(w1))
            intervals.append((a, b))
            self.kernels.append(dict(name=e.name(), dur_s=(b - a) * 1e-9,
                                     phase=phase(t)))
        self.linked_share = linked / max(len(dev), 1)
        busy = _merge(intervals)
        self.busy_s = sum(b - a for a, b in busy) * 1e-9
        edges = [(w0, w0)] + busy + [(w1, w1)]
        self._gaps = sorted(((edges[i + 1][0] - edges[i][1]) * 1e-9,
                             phase((edges[i][1] + edges[i + 1][0]) / 2))
                            for i in range(len(edges) - 1)
                            if edges[i + 1][0] > edges[i][1])[::-1]

    # -- for the readers -----------------------------------------------------
    def kernel_module(self, name: str):
        return importlib.import_module(f"benchmark.kernels.{name}")

    def launches(self, kernel: str) -> List[dict]:
        """The device events of kernel ``kernel`` (``benchmark/kernels/``),
        each with its phase."""
        k = self.kernel_module(kernel)
        return [e for e in self.kernels if k.NAME in e["name"]]

    def roofline(self, kernel: str) -> Optional[float]:
        """Sum of the launches' bounds over their device time, in %; None
        when the kernel did not run in the window."""
        k = self.kernel_module(kernel)
        runs = self.launches(kernel)
        if not runs:
            return None
        bound = sum(k.bound_s(self.d, self.cfg, e["phase"]) for e in runs)
        return 100.0 * bound / sum(e["dur_s"] for e in runs)

    def breakdown(self) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for e in self.kernels:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur_s"]
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[f"host in {p}", s] for s, p in
                              self._gaps[:10]]}
