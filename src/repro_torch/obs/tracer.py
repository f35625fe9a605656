"""Structured span tracer: nested timed spans with attributes (DESIGN.md §8).

One tracing substrate for the whole stack.  A :class:`Span` is a named,
timed interval with attributes, a *track* (the Perfetto row it renders
on), a nesting depth, an ``id`` (its open order), the ``parent`` id of
the span open around it and a ``step`` (the product it belongs to).  The
taxonomy threaded through the port, by layer::

    session.simulate                 api/session.py   one simulator phase
    plan.compile / plan.run          api/plan.py      lowering vs (re)execution
      plan.rebind / plan.replay     api/plan.py      run sub-phases
    qt.multiply, qt.sym_square,      core/multiply.py a task program's root
      qt.syrk, qt.sym_multiply,                       entry (attrs: tasks,
      qt.add, qt.transpose, qt.scale                  leaf_tasks, pairs,
                                                      pairs_s)
    qt.from_dense / qt.from_coo      core/quadtree.py construction
    engine.flush                     core/tasks.py    deferred-wave drain
      engine.wave                   core/engine.py   one cross-leaf batch
        engine.gather               core/engine.py   slots, stacks, sort
                                                      (attrs: pairs,
                                                      unique_blocks)
        kernel.dispatch             core/engine.py   the fused kernel call
          copy.h2d                 core/engine.py   pin, enqueue operands
          copy.d2h                 core/engine.py   C to the host, sync
        engine.scatter              core/engine.py   C's blocks to leaves
        collective.ppermute         launch/mesh_exec ring-shift shipments
      engine.host_fill              core/engine.py   host adds, transposes
    gc.collect                       (any depth)      one pass of the collector

``Tracer.counters`` holds running totals beside the spans, for work too
fine-grained for a span of its own: ``engine.leaf_tasks``,
``engine.pairs`` and ``engine.pairs_s`` (the C structure and pair count
of each leaf task, host fills' structures included, and a truncated
multiply's kept-pair test, at registration and at replay:
``TorchEngine.execute`` and ``reexecute``, timed on :meth:`Tracer.clock`,
which leaves the collector out; no pair is enumerated there),
``engine.pairs_joined`` (the block pairs the flush's wave-wide join
enumerates: ``engine.pairs`` less a truncated
multiply's frozen pairs), a truncated
multiply's ``trunc.pairs_pruned`` (block pairs its leaf tasks drop),
``trunc.subtrees_pruned`` (recursive products it drops, any level) and
``trunc.test_s`` (its leaf tasks' norm tests, on the same clock), and
``gc.collect_s`` (the collector's seconds).  A truncated ``qt.multiply``
root span also carries ``error_bound`` and ``pruned_pairs``, what that
product pruned.  ``Tracer.step`` starts at
0 and ``Session.flush()`` advances it once the engine has drained, so a
product's registration spans and its flush share one step.  Every live
recording tracer also records the interpreter's cyclic collector: one
``gc.collect`` span per pass (track ``host``), a child of whatever span
the pass interrupted.

Tracing is **off by default**: every instrumented call site holds a
:data:`NOOP` tracer whose :meth:`~NoopTracer.span` returns a shared,
stateless context manager — no allocation beyond the argument dict, no
timing calls, no growth — and whose :meth:`~NoopTracer.add` does nothing.
The collector hook is installed when the first :class:`Tracer` is made,
never in a process that only holds :data:`NOOP`.  The no-op path changes
*nothing* observable (task graph, schedule, counters); ``Session(trace=
True)`` or ``Session.tracing()`` swaps in a recording :class:`Tracer`.

Design constraints (held by tests/test_torch_obs.py and
tests/test_torch_runtime.py):

* spans are **coarse** — per plan run, per simulator phase, per engine
  wave, per task program's root; never per task (per-task work goes to
  counters) — so the recording overhead stays small on a
  registration-bound workload;
* instrumentation is purely additive: it never touches RNG state,
  registration order, or chunk contents;
* span records are plain data (name, t0, t1, track, depth, attrs, id,
  parent, step) so exporters (:mod:`repro_torch.obs.export`) need no
  back-references.
"""
from __future__ import annotations

import dataclasses
import gc
import time
import types
import weakref
from typing import Optional

__all__ = ["Span", "Tracer", "NoopTracer", "NOOP"]


@dataclasses.dataclass
class Span:
    """One closed span: a timed interval on a track, with attributes.

    ``id`` is the span's open order in its tracer (-1 for a span built by
    hand), ``parent`` the id of the span open around it (None at top
    level) and ``step`` the tracer's step when it opened."""
    name: str
    t0: float               # seconds since the tracer's epoch
    t1: float
    track: str = "main"
    depth: int = 0          # nesting depth at open time (0 = top level)
    attrs: dict = dataclasses.field(default_factory=dict)
    id: int = -1
    parent: Optional[int] = None
    step: int = 0

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "track": self.track, "depth": self.depth,
                "attrs": dict(self.attrs), "id": self.id,
                "parent": self.parent, "step": self.step}


class _LiveSpan:
    """An open span (the ``with tracer.span(...)`` handle)."""

    __slots__ = ("_tr", "name", "track", "attrs", "_t0", "_depth", "_id",
                 "_parent", "_step")

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
        tr = self._tr
        self._depth, self._parent, self._id = tr._open()
        self._step = tr.step
        tr._stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        tr = self._tr
        tr._stack.pop()
        tr.spans.append(Span(self.name, self._t0 - tr.epoch,
                             t1 - tr.epoch, self.track, self._depth,
                             self.attrs, self._id, self._parent,
                             self._step))
        return False


#: live recording tracers, each of which records the collector's passes
_RECORDING: "weakref.WeakSet[Tracer]" = weakref.WeakSet()


def _gc_hook(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: one ``gc.collect`` span per collector pass
    in every live recording tracer."""
    t = time.perf_counter()
    for tr in list(_RECORDING):
        if phase == "start":
            tr._gc_open = (tr._open(), tr.step, t)
        elif tr._gc_open is not None:
            (depth, parent, sid), step, t0 = tr._gc_open
            tr._gc_open = None
            tr.spans.append(Span("gc.collect", t0 - tr.epoch, t - tr.epoch,
                                 "host", depth,
                                 {"generation": info["generation"]},
                                 sid, parent, step))
            tr.add("gc.collect_s", t - t0)


class Tracer:
    """Recording tracer: collects :class:`Span` records in close order.

    >>> tr = Tracer()
    >>> with tr.span("plan.run", runs=1) as sp:
    ...     with tr.span("engine.wave", track="engine"):
    ...         pass
    ...     sp.set(tasks=42)
    >>> [s.name for s in tr.spans if s.name != "gc.collect"]
    ['engine.wave', 'plan.run']

    Spans close inner-first; :meth:`ordered` returns them sorted by start
    time (the order exporters want).  ``epoch`` is the perf_counter value
    at construction, so all ``t0``/``t1`` are small relative offsets.
    ``counters`` holds running totals (:meth:`add`); ``step`` is the
    current product's id.
    """

    enabled = True

    def __init__(self):
        self.spans: list[Span] = []
        self._stack: list[_LiveSpan] = []
        self.counters: dict = {}
        self.step = 0
        self._next_id = 0
        self._gc_open = None
        self.epoch = time.perf_counter()
        if _gc_hook not in gc.callbacks:
            gc.callbacks.append(_gc_hook)
        _RECORDING.add(self)

    def _open(self) -> tuple:
        """(depth, parent id, id) of a span opening now."""
        sid = self._next_id
        self._next_id += 1
        st = self._stack
        return len(st), (st[-1]._id if st else None), sid

    def span(self, name: str, track: str = "main", **attrs) -> _LiveSpan:
        """Open a nested span; use as a context manager."""
        return _LiveSpan(self, name, track, attrs)

    def instant(self, name: str, track: str = "main", **attrs) -> None:
        """Record a zero-duration marker (Perfetto instant event)."""
        t = time.perf_counter() - self.epoch
        depth, parent, sid = self._open()
        self.spans.append(Span(name, t, t, track, depth, attrs, sid, parent,
                               self.step))

    def add(self, name: str, v=1) -> None:
        """Add ``v`` to the running total ``counters[name]``."""
        c = self.counters
        c[name] = c.get(name, 0) + v

    def clock(self) -> float:
        """``time.perf_counter()`` less the collector's seconds so far
        (``counters["gc.collect_s"]``): an interval on this clock leaves
        out the collector's passes, which ``gc.collect`` spans hold."""
        return time.perf_counter() - self.counters.get("gc.collect_s", 0.0)

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
        """Forget the recorded spans and counters."""
        self.spans.clear()
        self.counters.clear()

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

    ``spans`` is an empty tuple and ``counters`` an empty read-only
    mapping (shared, immutable) so reporting code can treat both tracer
    kinds uniformly.
    """

    enabled = False
    spans: tuple = ()
    counters = types.MappingProxyType({})

    def span(self, name: str, track: str = "main", **attrs) -> _NoopSpan:
        return _NOOP_SPAN

    def instant(self, name: str, track: str = "main", **attrs) -> None:
        pass

    def add(self, name: str, v=1) -> None:
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
