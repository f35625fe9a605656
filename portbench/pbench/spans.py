"""Host spans of a traced window and the arithmetic on them.

A span is ``(name, t0, t1)`` on the host's clock (``time.perf_counter``).
The benchmark opens its own around the calls into each layer, once per
product: ``register`` (the operator call), ``rebind`` (``Plan.run``
without a flush), ``flush`` (``Session.flush``) and ``free``
(``Session.free``); the program adds ``kernel.dispatch`` inside a flush
(its copies, its kernel and a synchronize).
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
