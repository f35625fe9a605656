"""Fault schedules and chunk recovery for the runtime simulator (§10).

The Chunks and Tasks model advertises fault tolerance as a consequence of
its two core invariants: chunks are immutable, and every task's inputs
(the lineage) are recorded at registration.  This module is the simulator
side of that claim — it defines

* :class:`FaultEvent` / :class:`FaultSchedule` — a deterministic schedule
  of worker deaths, stragglers and elastic join/leave events in
  *simulated* time, passed to ``Session.simulate(faults=...)`` /
  ``Scheduler.run(faults=...)``;
* :class:`RecoveryManager` — the per-:class:`~repro_torch.runtime.scheduler.
  Scheduler` policy object that reacts to a death.  Two recovery modes
  plus a deliberately bad baseline:

  - ``"lineage"`` (default): walk the recorded producer graph
    (``Scheduler.unsimulated_closure``) and re-enqueue the *minimal* task
    closure that regenerates the lost chunks — nothing else re-runs.
  - ``"replication"``: keep ``replicas`` physical copies of every placed
    chunk on distinct workers (made at registration time, ring-successor
    placement); a death re-points placements at a surviving copy and
    re-replicates to restore the factor.  Recompute only happens when
    every copy died, so replication *bounds* recompute work at the price
    of r× memory and registration bandwidth.
  - ``"none"``: the no-fault-tolerance baseline — a death restarts the
    whole phase (every task completed so far re-runs), which is what a
    plain SPMD job without checkpoints would do.

Wall-clock effects (aborted in-flight work, redistribution, recompute)
are modelled inside the discrete-event loop of
:mod:`repro_torch.runtime.scheduler`; this module owns only the policy and its
bookkeeping (replica maps, recovery counters).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.chunks import ChunkId

__all__ = ["ACTIONS", "RECOVERIES", "FaultEvent", "FaultSchedule",
           "RecoveryManager", "as_fault_schedule", "kill", "slow", "join",
           "leave"]

ACTIONS = ("kill", "slow", "join", "leave")
RECOVERIES = ("none", "replication", "lineage")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled event at simulated time ``t`` (seconds).

    Actions: ``"kill"`` (worker dies, its owned chunks are lost, its
    in-flight task is wasted), ``"slow"`` (worker's compute time is
    multiplied by ``factor`` from ``t`` on — a straggler), ``"join"``
    (a fresh worker enters the pool and starts stealing), ``"leave"``
    (graceful departure: the worker stops taking work but its chunks
    stay readable — think preemption with data drain).
    """
    t: float
    action: str
    worker: Optional[int] = None
    factor: float = 1.0

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}; "
                             f"pick one of {ACTIONS}")
        if self.t < 0:
            raise ValueError(f"fault event time must be >= 0, got {self.t}")
        if self.action != "join" and self.worker is None:
            raise ValueError(f"{self.action!r} event needs a worker index")
        if self.action == "slow" and self.factor <= 0:
            raise ValueError(f"slow factor must be > 0, got {self.factor}")


def kill(t: float, worker: int) -> FaultEvent:
    """Worker death at simulated time ``t``."""
    return FaultEvent(t, "kill", worker)


def slow(t: float, worker: int, factor: float) -> FaultEvent:
    """Straggler: ``worker`` computes ``factor``× slower from ``t`` on."""
    return FaultEvent(t, "slow", worker, factor)


def join(t: float) -> FaultEvent:
    """Elastic join: a new worker enters the pool at ``t``."""
    return FaultEvent(t, "join")


def leave(t: float, worker: int) -> FaultEvent:
    """Graceful leave: stop scheduling onto ``worker``; chunks survive."""
    return FaultEvent(t, "leave", worker)


@dataclasses.dataclass
class FaultSchedule:
    """A deterministic fault scenario: events + recovery policy.

    ``events`` accepts :class:`FaultEvent` instances or plain
    ``(t, action, ...)`` tuples and is kept sorted by time (stable, so
    same-time events apply in the order given — two kills at one instant
    are expressible).  Events later than the end of the run never fire.
    An *empty* schedule with ``recovery="replication"`` is meaningful:
    it turns on r-way replication at registration for that run (e.g. the
    build phase) without injecting any failure.
    """
    events: Sequence = ()
    recovery: str = "lineage"
    replicas: int = 2

    def __post_init__(self):
        if self.recovery not in RECOVERIES:
            raise ValueError(f"unknown recovery policy {self.recovery!r}; "
                             f"pick one of {RECOVERIES}")
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        evs = [e if isinstance(e, FaultEvent) else FaultEvent(*e)
               for e in self.events]
        self.events = sorted(evs, key=lambda e: e.t)

    def kill_times(self) -> dict:
        """worker -> simulated time of its (first) scheduled death."""
        kt: dict = {}
        for e in self.events:
            if e.action == "kill" and e.worker not in kt:
                kt[e.worker] = e.t
        return kt


def as_fault_schedule(faults) -> Optional[FaultSchedule]:
    """Normalise ``faults``: None, a FaultSchedule, or an event iterable."""
    if faults is None or isinstance(faults, FaultSchedule):
        return faults
    return FaultSchedule(events=list(faults))


class RecoveryManager:
    """Recovery policy + bookkeeping for one :class:`Scheduler`.

    Counters are zeroed by :meth:`begin_run` and surface on the run's
    :class:`~repro_torch.runtime.scheduler.SimReport`.  The replica map
    persists across runs (replicas made during the build phase protect
    the input matrices through later multiply phases).
    """

    def __init__(self, sched):
        self.sched = sched
        self.policy: Optional[str] = None    # None while no schedule active
        self.replicas = 2
        # producer node id -> replica ChunkIds (copies beyond the placement)
        self._replica_of: dict[int, list] = {}
        self.chunks_lost = 0
        self.bytes_lost = 0
        self.bytes_rereplicated = 0
        self.tasks_recomputed = 0
        self.chunks_recovered = 0
        self.events_applied: list[dict] = []

    def begin_run(self, schedule: Optional[FaultSchedule]) -> None:
        self.chunks_lost = 0
        self.bytes_lost = 0
        self.bytes_rereplicated = 0
        self.tasks_recomputed = 0
        self.chunks_recovered = 0
        self.events_applied = []
        if schedule is None:
            self.policy = None
        else:
            self.policy = schedule.recovery
            self.replicas = schedule.replicas

    # -- r-way replication at registration ----------------------------------
    def on_place(self, nid: int, cid: ChunkId, nbytes: int,
                 live: list) -> tuple[int, int]:
        """Replicate a freshly placed chunk onto ``replicas - 1`` other
        live workers; returns ``(bytes shipped, messages)`` so the
        scheduler can charge the transfer on the producing task."""
        if self.policy != "replication" or nbytes <= 0:
            return 0, 0
        reps, shipped = self._make_replicas(cid, nbytes, live, existing=())
        if reps:
            self._replica_of[nid] = reps
        return shipped, len(reps)

    def _make_replicas(self, cid: ChunkId, nbytes: int, live: list,
                       existing) -> tuple[list, int]:
        """Copies on ring-successor live workers not already holding one."""
        holders = {cid.owner} | {r.owner for r in existing}
        ring = sorted(v for v in live if v not in holders)
        # start after the owner so replicas spread around the ring
        ring = [v for v in ring if v > cid.owner] + \
               [v for v in ring if v < cid.owner]
        need = self.replicas - len(holders)
        reps: list = []
        shipped = 0
        for dst in ring[:max(0, need)]:
            reps.append(self.sched.store.replicate(cid, dst))
            shipped += nbytes
        return reps, shipped

    def drop_replicas(self, nid: int) -> list:
        """Release bookkeeping when a node's chunks are freed; returns
        the replica ids the caller must free from the store."""
        return self._replica_of.pop(nid, [])

    # -- death ---------------------------------------------------------------
    def on_death(self, g, w: int, done_run: set) -> set:
        """Chunk-loss recovery after ``store.drop_worker(w)``.

        Pops every placement owned by the dead worker, re-points lost
        chunks at surviving replicas where the policy keeps them, and
        returns the producer node ids whose outputs are irrecoverably
        lost — the seed of the lineage recompute closure (under policy
        ``"none"`` that seed is the whole phase so far: a full re-run).
        """
        sched = self.sched
        placement = sched.placement
        live = sched.live_workers()
        lost = sorted(nid for nid, cid in placement.items()
                      if cid.owner == w)
        for nid in lost:
            placement.pop(nid, None)
        # producers whose output chunk vanished; aliases merely lose their
        # placement entry (fetches resolve through the producer anyway)
        producers = {nid for nid in lost
                     if g.nodes[nid].alias_of is None
                     and g.placed(g.nodes[nid]) is not None}
        recompute: set = set()
        if self.policy == "replication":
            # 1) re-point lost placements at a surviving replica
            for nid in sorted(producers):
                reps = [r for r in self._replica_of.get(nid, ())
                        if r.owner != w]
                if reps:
                    placement[nid] = reps.pop(0)
                    self._replica_of[nid] = reps
                    self.chunks_recovered += 1
                else:
                    self._replica_of.pop(nid, None)
                    recompute.add(nid)   # every copy died: fall back
            # 2) drop replicas that lived on the dead worker, then restore
            #    the replication factor from each surviving primary
            for nid in sorted(self._replica_of):
                reps = [r for r in self._replica_of[nid] if r.owner != w]
                prim = placement.get(nid)
                if prim is None or prim.owner == w:
                    self._replica_of.pop(nid)
                    continue
                more, shipped = self._make_replicas(
                    prim, sched.store.size_of(prim), live, existing=reps)
                self.bytes_rereplicated += shipped
                reps += more
                if reps:
                    self._replica_of[nid] = reps
                else:
                    self._replica_of.pop(nid)
        elif self.policy == "none":
            # no fault tolerance: the phase restarts from scratch
            recompute = set(done_run) | producers
        else:                            # "lineage" (also the default)
            recompute = producers
        if self.policy != "replication":
            # any replicas from an earlier replication run lose their
            # dead-worker copies regardless of the current policy
            for nid in list(self._replica_of):
                alive = [r for r in self._replica_of[nid] if r.owner != w]
                if alive:
                    self._replica_of[nid] = alive
                else:
                    self._replica_of.pop(nid)
        return recompute
