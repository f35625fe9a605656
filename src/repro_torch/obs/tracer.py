"""Structured span tracer: nested timed spans with attributes (DESIGN.md §8).

One tracing substrate for the whole stack.  A :class:`Span` is a named,
timed interval with attributes, a *track* (the Perfetto row it renders
on) and a nesting depth; the taxonomy threaded through the repo is::

    session.simulate                 api/session.py   one simulator phase
    plan.compile / plan.run          api/plan.py      lowering vs (re)execution
      plan.rebind / plan.replay     api/plan.py      run sub-phases
    qt.multiply / qt.from_dense ...  core/multiply.py, core/quadtree.py
    engine.flush                     core/tasks.py    deferred-wave drain
      engine.wave                   core/engine.py   one cross-leaf batch
        kernel.dispatch             core/engine.py   the fused kernel call
        collective.ppermute         launch/mesh_exec ring-shift shipments

Tracing is **off by default**: every instrumented call site holds a
:data:`NOOP` tracer whose :meth:`~NoopTracer.span` returns a shared,
stateless context manager — no allocation beyond the argument dict, no
timing calls, no growth.  The no-op path changes *nothing* observable
(task graph, schedule, counters); ``Session(trace=True)`` or
``Session.tracing()`` swaps in a recording :class:`Tracer`.

Design constraints (enforced by tests/test_obs.py and
benchmarks/bench_profile_overhead.py):

* spans are **coarse** — per plan run, per simulator phase, per engine
  wave; never per task — so the recording overhead stays < 3% on a
  registration-bound workload;
* instrumentation is purely additive: it never touches RNG state,
  registration order, or chunk contents;
* span records are plain data (name, t0, t1, track, depth, attrs) so
  exporters (:mod:`repro_torch.obs.export`) need no back-references.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

__all__ = ["Span", "Tracer", "NoopTracer", "NOOP"]


@dataclasses.dataclass
class Span:
    """One closed span: a timed interval on a track, with attributes."""
    name: str
    t0: float               # seconds since the tracer's epoch
    t1: float
    track: str = "main"
    depth: int = 0          # nesting depth at open time (0 = top level)
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "track": self.track, "depth": self.depth,
                "attrs": dict(self.attrs)}


class _LiveSpan:
    """An open span (the ``with tracer.span(...)`` handle)."""

    __slots__ = ("_tr", "name", "track", "attrs", "_t0", "_depth")

    def __init__(self, tr: "Tracer", name: str, track: str, attrs: dict):
        self._tr = tr
        self.name = name
        self.track = track
        self.attrs = attrs

    def set(self, **attrs) -> "_LiveSpan":
        """Attach (or update) attributes; chainable, valid until close."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_LiveSpan":
        self._depth = len(self._tr._stack)
        self._tr._stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        tr = self._tr
        tr._stack.pop()
        tr.spans.append(Span(self.name, self._t0 - tr.epoch,
                             t1 - tr.epoch, self.track, self._depth,
                             self.attrs))
        return False


class Tracer:
    """Recording tracer: collects :class:`Span` records in close order.

    >>> tr = Tracer()
    >>> with tr.span("plan.run", runs=1) as sp:
    ...     with tr.span("engine.wave", track="engine"):
    ...         pass
    ...     sp.set(tasks=42)
    >>> [s.name for s in tr.spans]
    ['engine.wave', 'plan.run']

    Spans close inner-first; :meth:`ordered` returns them sorted by start
    time (the order exporters want).  ``epoch`` is the perf_counter value
    at construction, so all ``t0``/``t1`` are small relative offsets.
    """

    enabled = True

    def __init__(self):
        self.spans: list[Span] = []
        self._stack: list[_LiveSpan] = []
        self.epoch = time.perf_counter()

    def span(self, name: str, track: str = "main", **attrs) -> _LiveSpan:
        """Open a nested span; use as a context manager."""
        return _LiveSpan(self, name, track, attrs)

    def instant(self, name: str, track: str = "main", **attrs) -> None:
        """Record a zero-duration marker (Perfetto instant event)."""
        t = time.perf_counter() - self.epoch
        self.spans.append(Span(name, t, t, track, len(self._stack), attrs))

    def ordered(self) -> list[Span]:
        """Spans sorted by start time (stable for equal starts)."""
        return sorted(self.spans, key=lambda s: s.t0)

    def find(self, name: str) -> list[Span]:
        """All closed spans with this name, in close order."""
        return [s for s in self.spans if s.name == name]

    def total(self, name: str) -> float:
        """Summed duration of all spans with this name."""
        return sum(s.duration for s in self.spans if s.name == name)

    def clear(self) -> None:
        self.spans.clear()

    def __len__(self) -> int:
        return len(self.spans)


class _NoopSpan:
    """Shared, stateless stand-in for a live span (no timing, no record)."""

    __slots__ = ()

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """The default tracer: every operation is a near-zero-cost no-op.

    ``spans`` is an empty tuple (shared, immutable) so reporting code can
    treat both tracer kinds uniformly.
    """

    enabled = False
    spans: tuple = ()

    def span(self, name: str, track: str = "main", **attrs) -> _NoopSpan:
        return _NOOP_SPAN

    def instant(self, name: str, track: str = "main", **attrs) -> None:
        pass

    def ordered(self) -> list:
        return []

    def find(self, name: str) -> list:
        return []

    def total(self, name: str) -> float:
        return 0.0

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0


#: process-wide shared no-op tracer; identity-comparable (`tr is NOOP`)
NOOP = NoopTracer()


def as_tracer(spec) -> "Tracer | NoopTracer":
    """Resolve a trace spec: False/None -> NOOP, True -> new Tracer,
    an existing tracer instance passes through."""
    if spec is None or spec is False:
        return NOOP
    if spec is True:
        return Tracer()
    if isinstance(spec, (Tracer, NoopTracer)):
        return spec
    raise ValueError(f"trace: expected bool or a Tracer, got {spec!r}")
