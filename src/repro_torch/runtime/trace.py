"""Execution traces of the Chunks-and-Tasks runtime simulator (DESIGN.md §4).

The scheduler records one :class:`TaskEvent` per executed task.  From the
trace (plus the task graph, whose node ids are topologically ordered — a
task is always registered after its dependencies and its parent) we derive
the schedule-independent quantities the paper's execution-time model rests
on (§5.3, eqs (13)-(14)):

* ``T1``   — total work: the serial execution time of all simulated tasks;
* ``Tinf`` — the critical path: the longest dependency chain, i.e. the
  wall time on infinitely many workers.  The makespan of any greedy
  work-stealing schedule obeys Brent's bound ``max(T1/p, Tinf)`` and is at
  most ``T1/p + Tinf``; the paper's polylog weak-scaling claim is exactly
  "Tinf is O(log^2 N) while T1/p stays constant".

The trace also renders an ASCII Gantt chart (worker occupancy over time)
and serialises to plain dicts for the benchmark JSON files.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["TaskEvent", "Trace", "CriticalPath", "critical_path"]


@dataclasses.dataclass(frozen=True)
class TaskEvent:
    """One executed task: where and when it ran, what it cost."""
    nid: int
    kind: str
    worker: int
    start: float
    end: float
    stolen: bool = False
    remote_bytes: int = 0     # cache-miss bytes fetched for the inputs
    remote_msgs: int = 0
    pushed_bytes: int = 0     # output chunk pushed to a non-local owner

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class CriticalPath:
    """T1 / Tinf summary of one simulated phase (paper eqs (13)-(14))."""
    work_s: float              # T1: sum of task durations
    length_s: float            # Tinf: longest dependency chain
    path: list[int]            # node ids along the critical chain, root-first
    n_tasks: int

    @property
    def avg_parallelism(self) -> float:
        from repro_torch.core.analysis import avg_parallelism
        return avg_parallelism(self.work_s, self.length_s)

    def brent_bound(self, p: int) -> float:
        """Greedy-schedule lower bound max(T1/p, Tinf)."""
        from repro_torch.core.analysis import brent_bound
        return brent_bound(self.work_s, self.length_s, p)

    def to_dict(self) -> dict:
        return {"work_s": self.work_s, "critical_path_s": self.length_s,
                "avg_parallelism": self.avg_parallelism,
                "n_tasks": self.n_tasks}


class Trace:
    """Ordered record of task executions for one :meth:`Scheduler.run`."""

    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self.events: list[TaskEvent] = []

    def append(self, ev: TaskEvent) -> None:
        self.events.append(ev)

    def __len__(self) -> int:
        return len(self.events)

    # -- schedule queries ---------------------------------------------------
    def schedule(self) -> dict[int, int]:
        """node id -> worker that executed it."""
        return {ev.nid: ev.worker for ev in self.events}

    def by_worker(self) -> list[list[TaskEvent]]:
        out: list[list[TaskEvent]] = [[] for _ in range(self.n_workers)]
        for ev in self.events:
            out[ev.worker].append(ev)
        return out

    def stolen_tasks(self) -> list[int]:
        return [ev.nid for ev in self.events if ev.stolen]

    def makespan(self) -> float:
        return max((ev.end for ev in self.events), default=0.0)

    # -- rendering / export -------------------------------------------------
    def gantt(self, width: int = 72) -> str:
        """ASCII occupancy chart: one row per worker, ``#`` busy, ``.`` idle.

        Each column is a makespan/width time slice; a slice is busy if any
        task execution overlaps it.  ``*`` marks a slice containing a stolen
        task's execution start.
        """
        span = self.makespan()
        if span <= 0 or not self.events:
            return "(empty trace)"
        rows = [["."] * width for _ in range(self.n_workers)]
        scale = width / span
        for ev in self.events:
            # clamp into [0, width-1]: a zero-duration tail event has
            # start == makespan, which scales to column `width` exactly
            lo = max(0, min(int(ev.start * scale), width - 1))
            hi = max(lo, min(int(ev.end * scale), width - 1))
            for c in range(lo, hi + 1):
                rows[ev.worker][c] = "#"
            if ev.stolen:
                rows[ev.worker][lo] = "*"
        lines = [f"w{w:<3d} |{''.join(r)}|" for w, r in enumerate(rows)]
        lines.append(f"     0{' ' * (width - 10)}{span * 1e3:8.2f} ms")
        return "\n".join(lines)

    def to_dicts(self) -> list[dict]:
        return [dataclasses.asdict(ev) for ev in self.events]


def critical_path(graph, trace: Trace,
                  done_before: Optional[set] = None) -> CriticalPath:
    """T1/Tinf of the traced phase from *actual simulated durations*.

    Precedence edges: resolved data dependencies, and parent -> child (a
    child task only becomes known to the runtime when its parent executes).
    Node ids are registration-ordered, hence topological — one forward pass
    suffices.  Nodes in ``done_before`` (simulated in an earlier phase, e.g.
    the matrix-construction program) contribute zero: the phase starts with
    them already materialised.

    An empty trace — nothing executed this phase, or every node already in
    ``done_before`` — yields the zero :class:`CriticalPath` rather than
    raising.
    """
    if not trace.events:
        return CriticalPath(work_s=0.0, length_s=0.0, path=[], n_tasks=0)
    done_before = done_before or set()
    # a fault-recovery run re-executes lost producers, so a nid can appear
    # twice; only the last execution's chunk survives, so keep the last
    # event per nid (processing order stays completion order, which keeps
    # the finish/pred pass acyclic even across forward alias links)
    last = {ev.nid: i for i, ev in enumerate(trace.events)}
    events = [ev for i, ev in enumerate(trace.events) if last[ev.nid] == i]
    dur: dict[int, float] = {}
    for ev in events:
        dur[ev.nid] = ev.duration
    finish: dict[int, float] = {}
    pred: dict[int, Optional[int]] = {}
    best_nid: Optional[int] = None
    for ev in events:                 # events appended in completion order,
        nid = ev.nid                  # but we walk edges by node id anyway
        node = graph.nodes[nid]
        t0, p0 = 0.0, None
        preds = [d.nid for d in node.deps] + [node.parent]
        for raw in preds:
            dn = graph.resolve(raw) if raw is not None else None
            if dn is None or dn in done_before or dn not in finish:
                continue
            if finish[dn] > t0:
                t0, p0 = finish[dn], dn
        finish[nid] = t0 + dur[nid]
        pred[nid] = p0
        if best_nid is None or finish[nid] > finish[best_nid]:
            best_nid = nid
    path: list[int] = []
    cur = best_nid
    while cur is not None and cur not in path:
        path.append(cur)
        cur = pred[cur]
    path.reverse()
    return CriticalPath(work_s=float(sum(dur.values())),
                        length_s=finish[best_nid],
                        path=path, n_tasks=len(trace.events))
