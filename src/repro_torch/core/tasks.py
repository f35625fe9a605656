"""Tasks: the work half of the Chunks and Tasks model + CHT-MPI-style scheduler.

Faithful simulation of the execution semantics the paper's results rest on
(§2.1), in two phases:

**Phase A — task registration & evaluation** (:class:`CTGraph`): the matrix
algorithms (multiply.py) run as ordinary recursive Python, but every
``register_task`` call records a node in a task DAG: parent/child structure
(the "local task tree"), data dependencies, whether each dependency is fetched
as chunk *content* or passed as a chunk *identifier* (createFromIds tasks pass
ids only — no data transfer), the produced chunk's size, and a cost model of
the task's work.  Values are computed eagerly so correctness is testable
against dense numpy.

**Phase B — cluster simulation** (:mod:`repro_torch.runtime.scheduler`, fronted
here by :class:`ClusterSim`): a virtual-time discrete-event simulation of
CHT-MPI's scheduling on ``p`` workers:

* each worker owns the tasks registered by tasks it executed (no master);
* idle workers **steal from a random victim, from the oldest end** of the
  victim's deque — "work stealing always occurs as high up as possible in the
  local task tree of the victim process" (paper §2.1);
* a task's children become available only after the parent executes;
* chunk placement *follows execution*: the output chunk lives on the worker
  that ran the task (paper §2.1: "each chunk object is by default owned by the
  worker process that created that chunk");
* fetching a remote chunk is accounted as communication unless it is in the
  worker's bounded LRU chunk cache (ChunkStore).

This yields the quantities of Figs 9-14: per-worker bytes received, makespan
under a machine model, peak memory, and task counts.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable, Optional

from .chunks import ChunkStore, ChunkId
from repro_torch.obs.tracer import NOOP

NILVAL = None


@dataclasses.dataclass
class Dep:
    """Dependency on another node's output chunk.

    fetch=True  -> task consumes chunk *content* (communication on miss)
    fetch=False -> task consumes the chunk *identifier* only (createFromIds)
    """
    nid: Optional[int]          # producer node id; None == NIL chunk id
    fetch: bool = True


@dataclasses.dataclass
class Node:
    nid: int
    kind: str
    parent: Optional[int]
    deps: list[Dep]
    children: list[int] = dataclasses.field(default_factory=list)
    value: Any = None               # chunk object produced (or None for NIL)
    alias_of: Optional[int] = None  # result is another node's chunk (no new chunk)
    out_nbytes: int = 0
    cost: float = 0.0               # modelled execution time (seconds)
    flops: float = 0.0              # useful flops (leaf compute)
    level: int = -1                 # quadtree level of the task (-1 = n/a)
    payload: Any = None             # batchable leaf-op description (engine.py)
    # structural decisions frozen at first execution so a Plan replay
    # (api/plan.py) re-runs the *same* program: today this is the
    # surviving block-pair list of a truncated leaf multiply, whose
    # norm test would otherwise re-evaluate against the rebound values
    replay: Any = None


@dataclasses.dataclass
class CostModel:
    """Wall-time model of one worker (defaults ~ one Erik-node CPU core)."""
    flops_per_s: float = 5e10       # leaf matrix compute rate
    task_overhead_s: float = 20e-6  # per-task administration (register/schedule)
    bandwidth_Bps: float = 6e9      # FDR InfiniBand-ish
    latency_s: float = 2e-6
    steal_latency_s: float = 50e-6


class CTGraph:
    """Phase A: records the task DAG while computing values eagerly.

    Leaf-level matrix work is routed through a pluggable **leaf engine**
    (engine.py): tasks registered with a ``payload`` carry a batchable
    description of their work instead of an opaque closure, and the engine
    decides whether to execute immediately (numpy backend) or defer and
    batch across the whole graph (torch backend).  Call :meth:`flush`
    before reading numeric chunk contents; graph *structure* (NIL-ness,
    task counts, flops attribution) is always final at registration.
    """

    def __init__(self, engine: Any = None) -> None:
        self.nodes: list[Node] = []
        self._parent: Optional[int] = None
        self._engine_spec = engine
        self._engine: Any = None
        # observability: a no-op tracer unless Session(trace=...) swaps in
        # a recording one; instrumentation never alters graph structure
        self.tracer = NOOP

    @property
    def engine(self):
        """The resolved leaf engine (constructed lazily)."""
        if self._engine is None:
            from .engine import make_engine
            self._engine = make_engine(self._engine_spec)
        return self._engine

    def flush(self) -> None:
        """Execute any deferred leaf work (batched waves on the engine)."""
        if self._engine is not None:
            if self.tracer.enabled:
                with self.tracer.span("engine.flush", track="engine"):
                    self._engine.flush(self)
            else:
                self._engine.flush(self)

    # -- core API used by the matrix library --------------------------------
    def register_task(self, kind: str, fn: Optional[Callable[..., Any]],
                      deps: list[Dep], cost: float = 0.0,
                      flops: float = 0.0, payload: Any = None) -> int:
        """Register & eagerly execute a task; returns its node id.

        ``fn`` receives the dep *values* (None for NIL / non-fetch deps get the
        producing node id instead of content) and returns either:
        * a chunk object (with .nbytes() or .nbytes) — a new chunk,
        * an ``Alias(nid)`` — result is another node's chunk,
        * None — NIL result.
        ``fn`` may recursively register subtasks; parentage is tracked.

        Alternatively pass ``payload`` (a :class:`~repro_torch.core.engine
        .LeafPayload`) instead of ``fn``: the task is dispatched through the
        graph's leaf engine, which may batch it with other leaf tasks.
        """
        nid = len(self.nodes)
        node = Node(nid=nid, kind=kind, parent=self._parent, deps=deps,
                    cost=cost, flops=flops, payload=payload)
        self.nodes.append(node)
        if self._parent is not None:
            self.nodes[self._parent].children.append(nid)
        saved = self._parent
        self._parent = nid
        try:
            if payload is not None:
                res = self.engine.execute(self, node, payload)
            else:
                vals = [self.value_of(d.nid) if d.fetch else d.nid
                        for d in deps]
                res = fn(*vals)
        finally:
            self._parent = saved
        if isinstance(res, Alias):
            node.alias_of = res.nid
            node.value = self.value_of(res.nid) if res.nid is not None else None
        else:
            node.value = res
            node.out_nbytes = _nbytes(res)
        return nid

    def register_chunk(self, kind: str, obj: Any) -> int:
        """A task that only materialises a chunk (zero-cost source node)."""
        return self.register_task(kind, lambda: obj, [], cost=0.0)

    def value_of(self, nid: Optional[int]) -> Any:
        if nid is None:
            return None
        n = self.nodes[nid]
        seen = set()
        while n.alias_of is not None:
            if n.nid in seen:  # pragma: no cover - defensive
                raise RuntimeError("alias cycle")
            seen.add(n.nid)
            n = self.nodes[n.alias_of]
        return n.value

    def resolve(self, nid: Optional[int]) -> Optional[int]:
        """Follow alias links to the node that actually owns the chunk."""
        if nid is None:
            return None
        n = self.nodes[nid]
        while n.alias_of is not None:
            n = self.nodes[n.alias_of]
        return n.nid

    def is_nil(self, nid: Optional[int]) -> bool:
        return nid is None or self.value_of(nid) is None

    # -- statistics (Figs 3-4) ----------------------------------------------
    def count_kinds(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for n in self.nodes:
            out[n.kind] = out.get(n.kind, 0) + 1
        return out


@dataclasses.dataclass
class Alias:
    nid: Optional[int]


def _nbytes(obj: Any) -> int:
    if obj is None:
        return 0
    nb = getattr(obj, "nbytes", None)
    if nb is None:
        return 64
    return int(nb() if callable(nb) else nb)


# ---------------------------------------------------------------------------
# Phase B: work-stealing cluster simulation — lives in runtime/scheduler.py.
# ClusterSim is kept as the historical front door: a thin wrapper over
# repro_torch.runtime.scheduler.Scheduler pinned to the paper's locality-aware
# "parent-worker" chunk placement.
# ---------------------------------------------------------------------------

class ClusterSim:
    """Discrete-event work-stealing simulation of a CHT-MPI cluster.

    Thin compatibility wrapper over
    :class:`repro_torch.runtime.scheduler.Scheduler` with the paper's
    ``parent-worker`` placement (chunk ownership follows execution).  Use
    the Scheduler directly for pluggable placement policies, execution
    traces, and critical-path statistics.

    Persistent across phases: chunk placements from a previous ``run`` (e.g.
    the task program that *built* the input matrices, cf. paper §7 "the data
    distribution of input matrices was a result of the task executions that
    generated those matrices") carry over to the next (the multiply), so the
    multiply's communication is measured against a realistic distribution.
    """

    def __init__(self, n_workers: int, cache_bytes: int = 1 << 62,
                 cost: CostModel | None = None, seed: int = 0,
                 placement: str = "parent-worker"):
        from repro_torch.runtime.scheduler import Scheduler  # lazy: no cycle
        self.p = n_workers
        self._sched = Scheduler(cost=cost, cache_bytes=cache_bytes,
                                seed=seed)
        self._placement_policy = placement

    @property
    def cost(self) -> CostModel:
        return self._sched.cost

    @property
    def rng(self) -> random.Random:
        return self._sched.rng

    @property
    def store(self) -> ChunkStore:
        if self._sched.store is None:
            self._sched._configure(self.p, self._placement_policy)
        return self._sched.store

    @property
    def placement(self) -> dict[int, ChunkId]:
        return self._sched.placement

    @property
    def _owner_of_node(self) -> dict[int, int]:
        return self._sched._owner_of_node

    def reset_stats(self) -> None:
        self.store  # ensure configured
        self._sched.reset_stats()

    def run(self, g: CTGraph, roots: list[int] | None = None,
            start_worker: int = 0) -> "SimResult":
        """Simulate execution of all not-yet-simulated nodes of ``g``."""
        return self._sched.run(g, n_workers=self.p,
                               placement=self._placement_policy,
                               start_worker=start_worker)


def __getattr__(name: str):
    # SimResult now lives in the runtime subsystem (as SimReport); keep the
    # old name importable from here.
    if name in ("SimResult", "SimReport"):
        from repro_torch.runtime.scheduler import SimReport
        return SimReport
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
