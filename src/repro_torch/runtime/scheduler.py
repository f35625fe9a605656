"""Chunks-and-Tasks runtime simulator: work-stealing scheduler with
locality-aware chunk placement (paper §2, Figs 9 and 11-14; DESIGN.md §4).

A discrete-event simulation that replays a recorded :class:`CTGraph` task
DAG over ``p`` virtual workers with CHT-MPI's scheduling semantics:

* **Task tree scheduling** — every worker keeps a deque of ready tasks.
  A task's children enter the deque of the worker that executed the parent;
  own work is popped newest-first (depth-first), keeping execution inside
  one subtree.
* **Randomized work stealing (§2.1)** — an idle worker picks a uniformly
  random victim among workers with ready tasks and steals from the *oldest*
  end of the victim's deque: "work stealing always occurs as high up as
  possible in the local task tree of the victim process".  Every steal pays
  :attr:`CostModel.steal_latency_s` on the thief's clock.
* **Chunk placement** — the output chunk of a task is registered with the
  :class:`ChunkStore` when the task completes.  *Where* it lands is the
  pluggable placement policy:

  - ``parent-worker`` (paper §2.1, the locality-aware default): the chunk is
    owned by the worker that executed the producing task — "each chunk
    object is by default owned by the worker process that created that
    chunk".  Placement *follows* the work-stealing execution over the
    quadtree, which is what makes per-worker communication essentially
    constant in weak scaling for matrices with data locality (Table 1).
  - ``round-robin`` / ``random`` (locality-oblivious baselines): ownership
    is assigned independently of execution; the producing worker must ship
    the chunk to its owner (the owner *receives* the bytes) and every later
    consumer fetches it remotely.

* **Communication accounting** — all input fetches are routed through the
  worker-local bounded LRU chunk cache of :class:`ChunkStore`; bytes
  received, messages, cache hits and peak owned bytes per worker are
  accounted exactly as plotted in Figs 11-13.
* **Modelled wall clock** — task duration is
  ``task_overhead_s + cost + flops / flops_per_s + fetch + push`` where
  each cache-miss fetch pays ``latency_s + nbytes / bandwidth_Bps`` and a
  non-local placement pays the same for the push.  This yields makespans,
  simulated speedup curves (Fig 9) and active fractions.

The simulator is *persistent across phases*: chunk placements from an
earlier :meth:`Scheduler.run` (e.g. the task program that built the input
matrices — paper §7: "the data distribution of input matrices was a result
of the task executions that generated those matrices") carry over to the
next run, so the multiply's communication is measured against a realistic
input distribution.  Call :meth:`reset_stats` between phases to isolate one
phase's communication.
"""
from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Optional

from repro_torch.core.chunks import ChunkId, ChunkStore
from repro_torch.core.tasks import CostModel, CTGraph

from .recovery import FaultSchedule, RecoveryManager, as_fault_schedule
from .trace import CriticalPath, TaskEvent, Trace, critical_path

PLACEMENTS = ("parent-worker", "round-robin", "random")

__all__ = ["Scheduler", "SimReport", "PLACEMENTS"]


@dataclasses.dataclass
class SimReport:
    """Per-phase statistics of one :meth:`Scheduler.run` (Figs 9, 11-13)."""
    makespan: float
    bytes_received: list[int]
    messages_received: list[int]
    peak_owned: list[int]
    tasks_per_worker: list[int]
    busy_time: list[float]
    steals: int
    n_workers: int = 1
    placement: str = "parent-worker"
    bytes_pushed: list[int] = dataclasses.field(default_factory=list)
    cache_hits: list[int] = dataclasses.field(default_factory=list)
    dedup_hits: list[int] = dataclasses.field(default_factory=list)
    flops_executed: list[float] = dataclasses.field(default_factory=list)
    steal_time_s: float = 0.0
    trace: Optional[Trace] = None
    crit: Optional[CriticalPath] = None
    # fault/recovery counters (DESIGN.md §10): all zero on fault-free runs
    chunks_lost: int = 0
    bytes_lost: int = 0
    tasks_recomputed: int = 0
    bytes_rereplicated: int = 0
    chunks_recovered: int = 0
    workers_failed: list[int] = dataclasses.field(default_factory=list)
    fault_events: list[dict] = dataclasses.field(default_factory=list)

    @property
    def n_failures(self) -> int:
        """Worker deaths applied during (or inherited by) this run."""
        return len(self.workers_failed)

    def degradation_vs(self, baseline: "SimReport") -> float:
        """Makespan ratio against a fault-free reference run."""
        if baseline.makespan <= 0:
            return float("inf") if self.makespan > 0 else 1.0
        return self.makespan / baseline.makespan

    @property
    def avg_bytes_received(self) -> float:
        return sum(self.bytes_received) / len(self.bytes_received)

    @property
    def max_bytes_received(self) -> int:
        return max(self.bytes_received)

    @property
    def n_tasks(self) -> int:
        """Tasks executed in this phase (truncation shrinks it)."""
        return sum(self.tasks_per_worker)

    @property
    def total_flops(self) -> float:
        """Useful flops executed in this phase across workers."""
        return sum(self.flops_executed)

    @property
    def active_fraction(self) -> list[float]:
        return [b / self.makespan if self.makespan > 0 else 0.0
                for b in self.busy_time]

    @property
    def work_s(self) -> float:
        """T1: total busy time across workers."""
        return sum(self.busy_time)

    @property
    def parallel_efficiency(self) -> float:
        from repro_torch.core.analysis import parallel_efficiency
        return parallel_efficiency(self.work_s, self.makespan,
                                   self.n_workers)

    def to_metrics(self):
        """This report in the unified counter schema (DESIGN.md §8).

        Returns a :class:`~repro_torch.obs.metrics.MetricSet` whose per-worker
        lists are this report's fields verbatim — ``bytes_received`` is
        the paper's cache-miss communication metric (Figs 11-13).
        """
        from repro_torch.obs.metrics import from_sim_report
        return from_sim_report(self)

    def to_dict(self) -> dict:
        d = {
            "n_workers": self.n_workers,
            "placement": self.placement,
            "makespan_s": self.makespan,
            "bytes_received": self.bytes_received,
            "bytes_pushed": self.bytes_pushed,
            "messages_received": self.messages_received,
            "peak_owned": self.peak_owned,
            "tasks_per_worker": self.tasks_per_worker,
            "n_tasks": self.n_tasks,
            "total_flops": self.total_flops,
            "steals": self.steals,
            "parallel_efficiency": self.parallel_efficiency,
        }
        if self.crit is not None:
            d.update(self.crit.to_dict())
        if self.fault_events or self.workers_failed:
            d.update({
                "workers_failed": list(self.workers_failed),
                "fault_events": list(self.fault_events),
                "chunks_lost": self.chunks_lost,
                "bytes_lost": self.bytes_lost,
                "tasks_recomputed": self.tasks_recomputed,
                "bytes_rereplicated": self.bytes_rereplicated,
                "chunks_recovered": self.chunks_recovered,
            })
        return d


def _pop_enabled(dq: list, now: float, newest: bool
                 ) -> Optional[tuple[int, float]]:
    """Pop an entry already enabled at ``now``, or None.

    Entries carry (nid, ready_time); ones with ready_time > now are not yet
    visible to a worker whose clock is ``now`` (their enabling completion
    lies in its future).  ``newest=True`` scans newest-first (own work,
    LIFO), ``newest=False`` oldest-first (steals go as high up the victim's
    task tree as possible).
    """
    order = range(len(dq) - 1, -1, -1) if newest else range(len(dq))
    for i in order:
        if dq[i][1] <= now:
            return dq.pop(i)
    return None


def _place(policy: str, creator: int, chunk_idx: int, p: int,
           rng: random.Random) -> int:
    if policy == "parent-worker":
        return creator
    if policy == "round-robin":
        return chunk_idx % p
    if policy == "random":
        return rng.randrange(p)
    raise ValueError(f"unknown placement {policy!r}; pick one of {PLACEMENTS}")


class Scheduler:
    """Discrete-event CHT-MPI cluster simulator over a :class:`CTGraph`.

    >>> sched = Scheduler(seed=0)
    >>> sched.run(g, n_workers=8)                   # build phase
    >>> sched.reset_stats()
    >>> rc = qt_multiply(g, params, ra, rb)
    >>> rep = sched.run(g, n_workers=8, placement="parent-worker")
    >>> rep.max_bytes_received, rep.makespan, rep.crit.length_s

    ``n_workers`` and ``placement`` are fixed by the first :meth:`run`;
    later runs may omit them but must not change them (the chunk store and
    ownership map are worker-count-specific).
    """

    def __init__(self, cost: CostModel | None = None,
                 cache_bytes: int = 1 << 62, seed: int = 0,
                 dedup: bool = False):
        self.cost = cost or CostModel()
        self.cache_bytes = cache_bytes
        self.dedup = dedup
        self.seed = seed
        self.rng = random.Random(seed)
        self.store: Optional[ChunkStore] = None
        self.n_workers: Optional[int] = None
        self.placement_policy: Optional[str] = None
        self.placement: dict[int, ChunkId] = {}   # node id -> chunk id
        self._owner_of_node: dict[int, int] = {}  # node id -> executing worker
        self._chunk_counter = 0                   # round-robin state
        # fault state persists across runs: a worker killed mid-phase stays
        # dead for every later phase/replay on this scheduler
        self._dead: set[int] = set()
        self._left: set[int] = set()              # graceful departures
        self._slow: dict[int, float] = {}         # straggler factors
        self.recovery = RecoveryManager(self)

    # -- worker liveness ----------------------------------------------------
    def live_workers(self) -> list[int]:
        """Workers currently able to run tasks / own new chunks."""
        return [w for w in range(self.n_workers)
                if w not in self._dead and w not in self._left]

    def _remap(self, worker: int) -> int:
        """A live stand-in for ``worker`` (itself when alive)."""
        if worker not in self._dead and worker not in self._left:
            return worker
        live = self.live_workers()
        if not live:
            raise RuntimeError("fault simulation: every worker is dead")
        return live[worker % len(live)]

    # -- lifecycle ----------------------------------------------------------
    def _configure(self, n_workers: Optional[int], placement: Optional[str]
                   ) -> None:
        if self.store is None:
            self.n_workers = n_workers or 1
            self.placement_policy = placement or "parent-worker"
            if self.placement_policy not in PLACEMENTS:
                raise ValueError(
                    f"unknown placement {self.placement_policy!r}; "
                    f"pick one of {PLACEMENTS}")
            self.store = ChunkStore(self.n_workers, self.cache_bytes,
                                    dedup=self.dedup)
        else:
            if n_workers is not None and n_workers != self.n_workers:
                raise ValueError(
                    f"scheduler already configured for {self.n_workers} "
                    f"workers; cannot re-run with {n_workers}")
            if placement is not None and placement != self.placement_policy:
                raise ValueError(
                    f"scheduler already configured for placement "
                    f"{self.placement_policy!r}; cannot re-run with "
                    f"{placement!r}")

    def reset_stats(self) -> None:
        """Zero per-worker counters; keep placements (phase isolation)."""
        if self.store is None:       # nothing simulated yet: nothing to zero
            return
        for s in self.store.stats:
            s.bytes_received = 0
            s.bytes_received_local = 0
            s.bytes_pushed = 0
            s.messages_received = 0
            s.cache_hits = 0
            s.tasks_executed = 0
            s.busy_time = 0.0
            s.dedup_hits = 0
            s.flops_executed = 0.0

    def replay(self, g: CTGraph, nids,
               faults: Optional[FaultSchedule] = None) -> SimReport:
        """Re-simulate an already-simulated *fixed* task program.

        Compiled-Plan re-execution (api/plan.py) registers zero new
        tasks, so a plain :meth:`run` would find nothing to do.  This
        marks the given nodes un-simulated again — freeing the chunks
        their previous execution placed (placements of everything
        *outside* the program, e.g. the input matrices, persist, so input
        fetches are charged against the realistic distribution exactly as
        in a first run) — and replays them through the normal
        discrete-event loop.  Combine with :meth:`reset_stats` to isolate
        one iteration's communication.
        """
        if self.store is None:          # nothing simulated yet: plain run
            return self.run(g, only=self.unsimulated_closure(g, nids),
                            faults=faults)
        self.release(g, nids, forget_owner=True)
        # restrict the re-run to the program (plus any genuinely
        # unsimulated prerequisites): other pending work — e.g. another
        # compiled-but-not-yet-simulated plan — keeps its own report
        return self.run(g, only=self.unsimulated_closure(g, nids),
                        faults=faults)

    def release(self, g: CTGraph, nids, forget_owner: bool = False) -> None:
        """Free the chunks these nodes placed; drop their placement
        entries.  Alias nodes lose only their placement entry (the
        resolved producer owns the chunk); ``forget_owner=True``
        additionally marks the nodes un-simulated so the next
        :meth:`run` executes them again (replay).  This is the single
        place placement/ownership bookkeeping is unwound — both program
        replay and :meth:`Session.free` go through it.
        """
        for nid in nids:
            if forget_owner:
                self._owner_of_node.pop(nid, None)
            cid = self.placement.pop(nid, None)
            node = g.nodes[nid]
            if cid is not None and node.alias_of is None \
                    and g.placed(node) is not None:
                self.store.free(cid)
            for rcid in self.recovery.drop_replicas(nid):
                self.store.free(rcid)

    def has_simulated(self, nids) -> bool:
        """Whether any of these nodes has already been executed on the
        virtual cluster (public accessor for Plan.simulate)."""
        return any(nid in self._owner_of_node for nid in nids)

    def simulated(self, nids) -> set:
        """Those of these nodes already executed on the virtual cluster."""
        return {nid for nid in nids if nid in self._owner_of_node}

    def unsimulated_closure(self, g: CTGraph, nids) -> set:
        """Not-yet-simulated nodes needed to simulate ``nids``.

        Walks dependencies (their producers must be placed), parents (a
        task becomes runnable only when its parent executed) and children
        (a container's subtree belongs to its program) over unsimulated
        nodes only.  This is the ``only`` filter for a restricted
        :meth:`run`: a fixed program simulates by itself, without
        sweeping in unrelated pending work.
        """
        seen: set = set()
        stack = list(nids)
        while stack:
            nid = stack.pop()
            if nid is None or nid in seen or nid in self._owner_of_node:
                continue
            seen.add(nid)
            node = g.nodes[nid]
            for d in node.deps:
                stack.append(g.resolve(d.nid))
            if node.parent is not None:
                stack.append(node.parent)
            stack.extend(node.children)
        return seen

    # -- the discrete-event loop -------------------------------------------
    def run(self, g: CTGraph, n_workers: Optional[int] = None,
            placement: Optional[str] = None, start_worker: int = 0,
            only: Optional[set] = None,
            faults: Optional[FaultSchedule] = None) -> SimReport:
        """Simulate all not-yet-simulated nodes of ``g``; returns stats.

        ``only`` restricts the pass to a node subset (see
        :meth:`unsimulated_closure`): nodes outside it stay pending for a
        later run.

        ``faults`` injects a deterministic :class:`~repro_torch.runtime.
        recovery.FaultSchedule` into this run's simulated timeline:
        worker deaths drop the dead worker's ChunkStore slice and recover
        by replica re-pointing or lineage recompute (the schedule's
        ``recovery`` policy), stragglers scale a worker's compute time,
        and join/leave events grow/shrink the pool mid-run.  Events later
        than the run's end never fire; dead/left workers stay out of the
        pool for every later run on this scheduler.  Fault handling never
        touches task *values* — only placement, timing and the recovery
        counters — so results stay bitwise identical to a fault-free run.
        """
        self._configure(n_workers, placement)
        schedule = as_fault_schedule(faults)
        self.recovery.begin_run(schedule)
        events = list(schedule.events) if schedule is not None else []
        g.flush()   # batched leaf waves must run so per-task flops are final
        tr = g.tracer
        todo = [n for n in g.nodes if n.nid not in self._owner_of_node
                and (only is None or n.nid in only)]
        trace = Trace(self.n_workers)
        if not todo:
            return self._report(0.0, 0, 0.0, trace, g, set())
        todo_ids = {n.nid for n in todo}
        done_before = set(self._owner_of_node)
        done_run: set = set()           # nids completed in *this* run

        # dependency bookkeeping: a task is runnable once its parent has
        # executed (it is then "registered") and all fetched deps are done.
        # ready_after[nid] is the virtual time of the last enabling event
        # (parent or dependency completion): execution may not start before
        # it, no matter how idle a worker's clock is.
        pending: dict[int, int] = {}
        dependents: dict[int, list[int]] = {}
        registered: dict[int, bool] = {}
        ready_after: dict[int, float] = {}
        for n in todo:
            cnt = 0
            for d in n.deps:
                dn = g.resolve(d.nid)
                if dn is not None and dn in todo_ids:
                    cnt += 1
                    dependents.setdefault(dn, []).append(n.nid)
            pending[n.nid] = cnt
            registered[n.nid] = (n.parent is None or n.parent not in todo_ids)
            ready_after[n.nid] = 0.0

        deques: list[list[tuple[int, float]]] = [
            [] for _ in range(self.n_workers)]
        free_at = [0.0] * self.n_workers
        n_steals = 0
        steal_time = 0.0
        # tasks whose worker died mid-execution (redistributed at the kill)
        aborted: dict[int, list[tuple[int, float]]] = {}
        kill_time = schedule.kill_times() if schedule is not None else {}

        def push_ready(nid: int, worker: int) -> None:
            worker = self._remap(worker)
            self._owner_of_node[nid] = worker
            deques[worker].append((nid, ready_after[nid]))

        for n in todo:
            if registered[n.nid] and pending[n.nid] == 0:
                push_ready(n.nid, start_worker)

        time_now = 0.0
        # fault events ride the same heap as negative sentinel ids: an
        # event at time t pops before any worker whose clock reaches t,
        # and same-time events apply in schedule order
        n_ev = len(events)
        heap = [(0.0, w) for w in self.live_workers()]
        heap += [(ev.t, i - n_ev) for i, ev in enumerate(events)]
        heapq.heapify(heap)
        executed = 0
        total = len(todo)
        blocked: list[tuple[float, int]] = []   # workers with no ready work

        def wake_blocked(tmin: float) -> None:
            nonlocal blocked
            for bt, bw in blocked:
                heapq.heappush(heap, (max(bt, tmin), bw))
            blocked = []

        def inject(nids, t_ev: float) -> list:
            """Put already-executed nodes back on the todo list (lineage
            recompute).  Returns the nids actually (re-)enqueued."""
            nonlocal total
            injected = []
            for nid in sorted(nids):
                if nid in todo_ids and nid not in done_run:
                    continue            # still pending: nothing to redo
                done_run.discard(nid)
                todo_ids.add(nid)
                ready_after[nid] = t_ev
                par = g.nodes[nid].parent
                # runnable once the parent executed: parents re-injected in
                # the same batch have lower nids and were re-added already
                registered[nid] = (par is None or par not in todo_ids
                                   or par in done_run)
                injected.append(nid)
            if not injected:
                return injected
            total += len(injected)
            # rebuild dependency counts from scratch: a re-injected
            # producer flips its consumers' satisfied edges back on
            dependents.clear()
            for x in sorted(todo_ids):
                if x in done_run:
                    continue
                cnt = 0
                for d in g.nodes[x].deps:
                    dn = g.resolve(d.nid)
                    if dn is not None and dn in todo_ids \
                            and dn not in done_run:
                        cnt += 1
                        dependents.setdefault(dn, []).append(x)
                pending[x] = cnt
            # queued entries whose deps were just lost are not runnable
            # anymore; they re-enter when the recomputed dep completes
            for dq in deques:
                dq[:] = [(q, rt) for q, rt in dq if pending[q] == 0]
            live = self.live_workers()
            qi = 0
            for nid in injected:
                if registered[nid] and pending[nid] == 0:
                    push_ready(nid, live[qi % len(live)])
                    qi += 1
            return injected

        def apply_event(ev) -> None:
            log = {"t": ev.t, "action": ev.action, "worker": ev.worker}
            if ev.action == "join":
                w_new = self.store.add_worker()
                self.n_workers = self.store.n_workers
                deques.append([])
                free_at.append(ev.t)
                trace.n_workers = self.n_workers
                heapq.heappush(heap, (ev.t, w_new))
                log["worker"] = w_new
                tr.instant("fault.join", track="fault", worker=w_new,
                           t_sim=ev.t)
            elif ev.action == "slow":
                self._slow[ev.worker] = float(ev.factor)
                log["factor"] = ev.factor
                tr.instant("fault.slow", track="fault", worker=ev.worker,
                           factor=ev.factor, t_sim=ev.t)
            else:                       # "kill" / "leave"
                w = ev.worker
                if not (0 <= w < self.n_workers) or w in self._dead \
                        or w in self._left:
                    log["skipped"] = True
                    self.recovery.events_applied.append(log)
                    return
                orphans = list(deques[w]) + aborted.pop(w, [])
                deques[w].clear()
                if ev.action == "leave":
                    self._left.add(w)
                    tr.instant("fault.leave", track="fault", worker=w,
                               t_sim=ev.t)
                else:
                    self._dead.add(w)
                    n_chunks, n_bytes = self.store.drop_worker(w)
                    self.recovery.chunks_lost += n_chunks
                    self.recovery.bytes_lost += n_bytes
                    log.update(chunks_lost=n_chunks, bytes_lost=n_bytes)
                    tr.instant("fault.kill", track="fault", worker=w,
                               t_sim=ev.t, chunks_lost=n_chunks,
                               bytes_lost=n_bytes)
                    with tr.span("fault.recover", track="fault", worker=w,
                                 t_sim=ev.t,
                                 policy=self.recovery.policy or "lineage"
                                 ) as sp:
                        recompute = self.recovery.on_death(g, w, done_run)
                        injected = []
                        if recompute:
                            self.release(g, sorted(recompute),
                                         forget_owner=True)
                            closure = self.unsimulated_closure(g, recompute)
                            injected = inject(closure, ev.t)
                            self.recovery.tasks_recomputed += len(injected)
                        log["tasks_recomputed"] = len(injected)
                        sp.set(tasks_recomputed=len(injected),
                               chunks_recovered=self.recovery
                               .chunks_recovered)
                # survivors inherit the lost worker's queued-but-unexecuted
                # tasks (only entries still runnable after the rewiring)
                live = self.live_workers()
                if not live:
                    raise RuntimeError(
                        "fault simulation: every worker is dead")
                runnable = [(q, rt) for q, rt in orphans
                            if q in todo_ids and q not in done_run
                            and pending.get(q, 1) == 0]
                for i, (q, rt) in enumerate(runnable):
                    tgt = live[i % len(live)]
                    self._owner_of_node[q] = tgt
                    deques[tgt].append((q, max(rt, ev.t)))
            self.recovery.events_applied.append(log)
            wake_blocked(ev.t)

        while executed < total:
            if not heap:
                if not blocked:
                    raise RuntimeError("deadlock in task graph simulation")
                t = min(b[0] for b in blocked)
                for bt, w in blocked:
                    heapq.heappush(heap, (max(bt, t), w))
                blocked = []
                continue
            t, w = heapq.heappop(heap)
            if w < 0:                   # fault-event sentinel
                apply_event(events[w + n_ev])
                continue
            if w in self._dead or w in self._left:
                continue                # stale entry of a removed worker
            time_now = max(time_now, t)
            nid = None
            stolen = False
            got = _pop_enabled(deques[w], t, newest=True)   # own work first
            if got is not None:
                nid, _ = got
            else:
                victims = [v for v in self.live_workers() if v != w
                           and any(rt <= t for _, rt in deques[v])]
                if victims:
                    v = self.rng.choice(victims)
                    nid, _ = _pop_enabled(deques[v], t, newest=False)
                    self._owner_of_node[nid] = w
                    t += self.cost.steal_latency_s
                    steal_time += self.cost.steal_latency_s
                    n_steals += 1
                    stolen = True
            if nid is None:
                # nothing enabled yet anywhere at this worker's clock: wait
                # for the next enabling event (if one is pending) or block
                future = [rt for dq in deques for _, rt in dq]
                if future:
                    heapq.heappush(heap, (min(future), w))
                else:
                    blocked.append((t, w))
                continue

            node = g.nodes[nid]
            st = self.store.stats[w]
            # fetch inputs through the chunk cache (misses = communication)
            fetch_time = 0.0
            rb0, rm0 = st.bytes_received, st.messages_received
            for d in node.deps:
                if not d.fetch:
                    continue
                dn = g.resolve(d.nid)
                cid = self.placement.get(dn) if dn is not None else None
                if cid is not None:
                    before = st.bytes_received
                    msgs_before = st.messages_received
                    self.store.fetch(w, cid)
                    dbytes = st.bytes_received - before
                    dmsgs = st.messages_received - msgs_before
                    fetch_time += dbytes / self.cost.bandwidth_Bps \
                        + dmsgs * self.cost.latency_s
            remote_bytes = st.bytes_received - rb0
            remote_msgs = st.messages_received - rm0

            # straggler factor scales the compute term only (fetch/push are
            # network time); slow == 1.0 is bitwise-neutral
            compute = (self.cost.task_overhead_s + node.cost
                       + node.flops / self.cost.flops_per_s) \
                * self._slow.get(w, 1.0)
            t_kill = kill_time.get(w)
            if t_kill is not None and t + compute + fetch_time > t_kill:
                # the worker dies before this task can commit: the partial
                # work is wasted and the task returns to the pool when the
                # kill event fires (its chunk is never placed)
                st.busy_time += max(0.0, t_kill - t)
                aborted.setdefault(w, []).append((nid, ready_after[nid]))
                continue

            # produce + place the output chunk
            push_time = 0.0
            pushed_bytes = 0
            chunk = g.placed(node)
            if node.alias_of is None and chunk is not None:
                owner = _place(self.placement_policy, w, self._chunk_counter,
                               self.n_workers, self.rng)
                self._chunk_counter += 1
                owner = self._remap(owner)
                # charge ship time only for bytes the store actually moved:
                # a dedup hit resolves to an existing chunk id, no transfer
                pushed_before = self.store.stats[owner].bytes_pushed
                cid = self.store.register_pushed(w, owner, chunk,
                                                 node.out_nbytes)
                self.placement[nid] = cid
                shipped = self.store.stats[owner].bytes_pushed - pushed_before
                if shipped:
                    pushed_bytes = shipped
                    push_time = shipped / self.cost.bandwidth_Bps \
                        + self.cost.latency_s
                # r-way replication at registration (DESIGN.md §10)
                rbytes, rmsgs = self.recovery.on_place(
                    nid, cid, node.out_nbytes, self.live_workers())
                if rbytes:
                    push_time += rbytes / self.cost.bandwidth_Bps \
                        + rmsgs * self.cost.latency_s
            elif node.alias_of is not None:
                rn = g.resolve(nid)
                if rn in self.placement:
                    self.placement[nid] = self.placement[rn]

            dur = compute + fetch_time + push_time
            t_end = t + dur
            st.tasks_executed += 1
            st.busy_time += dur
            st.flops_executed += node.flops
            trace.append(TaskEvent(nid=nid, kind=node.kind, worker=w,
                                   start=t, end=t_end, stolen=stolen,
                                   remote_bytes=remote_bytes,
                                   remote_msgs=remote_msgs,
                                   pushed_bytes=pushed_bytes))

            executed += 1
            done_run.add(nid)
            for c in node.children:
                if c in registered and not registered[c]:
                    registered[c] = True
                    ready_after[c] = max(ready_after[c], t_end)
                    if pending[c] == 0:
                        push_ready(c, w)
            for dep_nid in dependents.get(nid, ()):
                pending[dep_nid] -= 1
                ready_after[dep_nid] = max(ready_after[dep_nid], t_end)
                if pending[dep_nid] == 0 and registered[dep_nid]:
                    parent = g.nodes[dep_nid].parent
                    push_ready(dep_nid,
                               self._owner_of_node.get(parent, w)
                               if parent is not None else w)
            free_at[w] = t_end
            heapq.heappush(heap, (t_end, w))
            if blocked:
                for bt, bw in blocked:
                    heapq.heappush(heap, (max(bt, time_now), bw))
                blocked = []

        makespan = max(free_at)
        return self._report(makespan, n_steals, steal_time, trace, g,
                            done_before)

    def _report(self, makespan: float, steals: int, steal_time: float,
                trace: Trace, g: CTGraph, done_before: set) -> SimReport:
        st = self.store.stats
        crit = critical_path(g, trace, done_before) if len(trace) else None
        rec = self.recovery
        return SimReport(
            chunks_lost=rec.chunks_lost,
            bytes_lost=rec.bytes_lost,
            tasks_recomputed=rec.tasks_recomputed,
            bytes_rereplicated=rec.bytes_rereplicated,
            chunks_recovered=rec.chunks_recovered,
            workers_failed=sorted(self._dead),
            fault_events=list(rec.events_applied),
            makespan=makespan,
            bytes_received=[s.bytes_received for s in st],
            messages_received=[s.messages_received for s in st],
            peak_owned=[s.peak_owned_bytes for s in st],
            tasks_per_worker=[s.tasks_executed for s in st],
            busy_time=[s.busy_time for s in st],
            steals=steals,
            n_workers=self.n_workers,
            placement=self.placement_policy,
            bytes_pushed=[s.bytes_pushed for s in st],
            cache_hits=[s.cache_hits for s in st],
            dedup_hits=[s.dedup_hits for s in st],
            flops_executed=[s.flops_executed for s in st],
            steal_time_s=steal_time,
            trace=trace,
            crit=crit,
        )


def simulate(g: CTGraph, n_workers: int, placement: str = "parent-worker",
             cost: CostModel | None = None, cache_bytes: int = 1 << 62,
             seed: int = 0,
             faults: Optional[FaultSchedule] = None) -> SimReport:
    """One-shot convenience: simulate the whole graph in a single phase."""
    sched = Scheduler(cost=cost, cache_bytes=cache_bytes, seed=seed)
    return sched.run(g, n_workers=n_workers, placement=placement,
                     faults=faults)
