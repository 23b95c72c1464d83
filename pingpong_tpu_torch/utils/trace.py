"""Spans and counters inside the program, with one switch for the process.

    from pingpong_tpu_torch.utils import trace

    trace.enable()
    with trace.span("learner::rollout"):
        counts = trace.readback(counts_on_card)      # counts.tolist()
    trace.count("gate::chunks")
    records = trace.drain()

Off (the default) :func:`span` returns one shared no-op context manager,
:func:`count` returns at once and :func:`readback` is exactly the read it
replaces (``read(t)``, ``t.tolist()`` unless another read is given):
nothing is allocated and no ``record_function`` is entered. On:

* a span records its name, its start and end (``time.perf_counter_ns``),
  the span it was opened in (per thread) and the try it belongs to: the
  self-play loop's ``(generation, try)``, which the ``loop::try`` span sets
  and every span opened inside it inherits;
* while a ``torch.profiler`` profile is recording, a span also enters
  ``torch.profiler.record_function(name)``, so it lies on the profiler's
  host timeline, the clock of the device events and of their launches'
  correlation ids (``utils/debug.py::profile_trace`` shows the spans);
* ``readback`` runs inside a ``sync::readback`` span and counts
  ``sync::readbacks``: the points where the host waits for the card;
* the records stay in memory up to a bound (the rest are counted as
  dropped) until :func:`drain` returns them with the counters and the
  kernels' launch totals (``ops/build.py``'s ``CudaKernel.launches``,
  reported, not counted a second time).

A span reads the host clock and nothing else: it never synchronizes and
never draws, so the program computes the same bits with tracing on or off.
:func:`summarize` folds drained records into the per-name counts, total and
self seconds that ``cli train --trace`` logs at each gate.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

MAX_RECORDS = 1 << 20
READBACK = "sync::readback"
READBACKS = "sync::readbacks"

_clock = time.perf_counter_ns


def _profiling() -> bool:
    """True while a ``torch.profiler`` profile records on this process."""
    return torch.autograd._profiler_enabled()


class _Noop:
    """The span of a process with tracing off: enters and exits, nothing
    else."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _Noop()


class Tracer:
    """The process's records, counters and switch (module functions below
    use one instance of it)."""

    def __init__(self):
        self.on = False
        self.max_records = MAX_RECORDS
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._records: List[tuple] = []
        self._dropped = 0
        self._counts: Dict[str, int] = {}

    def stack(self) -> List[Tuple[int, Optional[tuple]]]:
        """This thread's open spans, ``(id, try)`` innermost last."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def record(self, rec: tuple) -> None:
        with self._lock:
            if len(self._records) < self.max_records:
                self._records.append(rec)
            else:
                self._dropped += 1

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def drain(self) -> dict:
        with self._lock:
            records, self._records = self._records, []
            dropped, self._dropped = self._dropped, 0
            counts, self._counts = self._counts, {}
        from pingpong_tpu_torch.ops.build import launch_counts

        return dict(
            spans=[dict(id=i, parent=p, name=n, t0_ns=a, t1_ns=b, try_id=t)
                   for i, p, n, a, b, t in records],
            counters=counts, dropped=dropped,
            kernel_launches=launch_counts())


_TRACER = Tracer()


class _Span:
    """One span of a process with tracing on (or a timed span, which reads
    the clock either way and records only when tracing is on)."""

    __slots__ = ("name", "try_id", "recording", "id", "parent", "t0_ns",
                 "t1_ns", "_rf")

    def __init__(self, name: str, try_id: Optional[tuple] = None,
                 recording: bool = True):
        self.name = name
        self.try_id = try_id
        self.recording = recording
        self._rf = None

    def __enter__(self):
        if self.recording:
            st = _TRACER.stack()
            self.parent = None
            if st:
                self.parent, inherited = st[-1]
                if self.try_id is None:
                    self.try_id = inherited
            self.id = next(_TRACER._ids)
            st.append((self.id, self.try_id))
            if _profiling():
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
        self.t0_ns = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1_ns = _clock()
        if self.recording:
            if self._rf is not None:
                self._rf.__exit__(*exc)
                self._rf = None
            _TRACER.stack().pop()
            _TRACER.record((self.id, self.parent, self.name, self.t0_ns,
                            self.t1_ns, self.try_id))
        return False

    @property
    def seconds(self) -> float:
        """The span's length on its own clock readings."""
        return (self.t1_ns - self.t0_ns) * 1e-9


# ---------------------------------------------------------------------------
# The process's switch and what the program calls
# ---------------------------------------------------------------------------

def enable() -> None:
    """Turn tracing on for the process (at most ``MAX_RECORDS`` records
    kept between two drains)."""
    _TRACER.on = True


def disable() -> None:
    """Turn tracing off; the records taken so far wait for :func:`drain`."""
    _TRACER.on = False


def span(name: str, try_id: Optional[tuple] = None):
    """A context manager around one stage of the program. ``try_id`` (the
    loop's ``(generation, try)``) marks this span and every span opened
    inside it; without it a span takes its parent's."""
    if not _TRACER.on:
        return _NOOP
    return _Span(name, try_id)


def timed_span(name: str) -> _Span:
    """A span whose clock readings the caller also reads (``.seconds``
    after it closed), tracing on or off; recorded only when on."""
    return _Span(name, recording=_TRACER.on)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if _TRACER.on:
        _TRACER.count(name, int(n))


def _tolist(t):
    return t.tolist()


def readback(t, read: Callable = _tolist):
    """``read(t)``, the read of device data on the host that the caller
    would make (``t.tolist()``, ``float``, ``int``, an event's
    ``synchronize``): with tracing on, inside a ``sync::readback`` span and
    counted in ``sync::readbacks``."""
    if not _TRACER.on:
        return read(t)
    with _Span(READBACK):
        _TRACER.count(READBACKS, 1)
        return read(t)


def drain() -> dict:
    """The records taken since the last drain, and the counters, which
    restart: ``spans`` (dicts of ``id``, ``parent``, ``name``, ``t0_ns``,
    ``t1_ns``, ``try_id``; the clock is ``time.perf_counter_ns``),
    ``counters``, ``dropped`` (records beyond the bound) and
    ``kernel_launches`` (every CUDA kernel's launches so far)."""
    return _TRACER.drain()


def summarize(drained: dict) -> dict:
    """Per span name its ``count``, ``total_s`` and ``self_s`` (its time
    less that of its direct children), with the drained counters, the
    dropped records and the kernels' launch totals."""
    spans = drained["spans"]
    child_ns: Dict[int, int] = {}
    for s in spans:
        if s["parent"] is not None:
            child_ns[s["parent"]] = (child_ns.get(s["parent"], 0)
                                     + s["t1_ns"] - s["t0_ns"])
    out: Dict[str, dict] = {}
    for s in spans:
        row = out.setdefault(s["name"], dict(count=0, total_s=0.0,
                                             self_s=0.0))
        dur = s["t1_ns"] - s["t0_ns"]
        row["count"] += 1
        row["total_s"] += dur * 1e-9
        row["self_s"] += (dur - child_ns.get(s["id"], 0)) * 1e-9
    return dict(spans=out, counters=dict(drained["counters"]),
                dropped=drained["dropped"],
                kernel_launches=dict(drained["kernel_launches"]))
