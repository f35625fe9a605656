"""Host spans of a traced window and the arithmetic on them.

A span is ``(name, t0, t1)`` on the host's clock (``time.perf_counter``).
The benchmark opens its own around the calls into each layer, once per
product: ``register`` (the operator call), ``rebind`` (``Plan.run``
without a flush), ``flush`` (``Session.flush``) and ``free``
(``Session.free``); the program adds ``kernel.dispatch`` inside a flush
(its copies, its kernel and a synchronize).

A traced run also hands the metrics the program's own records
(``run.program``, :func:`pbench.cell.program_records`): its spans as
``(name, t0, t1, id, parent, attrs)``, each the child of the span whose
``id`` is its ``parent``, and its counters' change over the window.
:func:`program_self` and :func:`program_counter` read them, and give
None where the run holds no such record.
"""
from __future__ import annotations

#: names of the benchmark's own spans, in the order a product opens them
OWN = ("register", "rebind", "flush", "free")
#: the program's span of one kernel dispatch (copies, kernel, sync)
DISPATCH = "kernel.dispatch"


class Recorder:
    """Collects spans: ``with rec.span("flush"): ...``."""

    def __init__(self, clock):
        self.clock = clock
        self.spans: list = []

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    __slots__ = ("rec", "name", "t0")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.t0 = self.rec.clock()
        return self

    def __exit__(self, *exc):
        self.rec.spans.append((self.name, self.t0, self.rec.clock()))
        return False


def total(spans: list, name: str) -> float:
    """Summed seconds of the spans called ``name``."""
    return sum(b - a for n, a, b in spans if n == name)


def within(spans: list, name: str, parent: str) -> float:
    """Summed seconds of the ``name`` spans that lie inside a ``parent``
    span (by their intervals)."""
    outer = [(a, b) for n, a, b in spans if n == parent]
    return sum(b - a for n, a, b in spans if n == name
               and any(pa <= a and b <= pb for pa, pb in outer))


def self_time(spans: list, parent: str, child: str) -> float:
    """Seconds of the ``parent`` spans not covered by ``child`` spans
    inside them."""
    return total(spans, parent) - within(spans, child, parent)


def label_at(spans: list, t: float) -> str:
    """What the host was doing at ``t``: ``dispatch`` inside a kernel
    dispatch, ``pack`` elsewhere in a flush, else the benchmark's span
    open then, else ``between`` (the loop between products)."""
    open_ = {n for n, a, b in spans if a <= t < b}
    if DISPATCH in open_:
        return "dispatch"
    if "flush" in open_:
        return "pack"
    for n in OWN:
        if n in open_:
            return n
    return "between"


def label_gap(spans: list, a: float, b: float, steps: int = 16) -> str:
    """The label that covers most of the interval [a, b] (sampled)."""
    votes: dict = {}
    for i in range(steps):
        lab = label_at(spans, a + (b - a) * (i + 0.5) / steps)
        votes[lab] = votes.get(lab, 0) + 1
    return max(votes, key=votes.get)


def program_spans(run) -> list | None:
    """The program's spans that started inside the measured window, each
    with its self time: ``(name, self_s, attrs, id, parent)``, where the
    self time is the span's seconds less those of its children (a
    collector pass that interrupted it included).  None without
    records."""
    prog = getattr(run, "program", None)
    if not prog or prog.get("spans") is None:
        return None
    child: dict = {}
    for _, a, b, _, parent, _ in prog["spans"]:
        if parent is not None:
            child[parent] = child.get(parent, 0.0) + (b - a)
    w0 = prog["window"][0]
    return [(name, (b - a) - child.get(sid, 0.0), attrs, sid, parent)
            for name, a, b, sid, parent, attrs in prog["spans"] if a >= w0]


def program_self(run, name: str) -> float | None:
    """Seconds per product of self time in the program's ``name`` spans
    of the window; None where there is none."""
    spans = program_spans(run)
    got = [t for n, t, *_ in spans or () if n == name]
    return sum(got) / run.products if got else None


def program_counter(run, name: str) -> float | None:
    """The change of the program's counter ``name`` over the window;
    None where the program keeps no such counter."""
    prog = getattr(run, "program", None)
    return ((prog and prog.get("counters")) or {}).get(name)
