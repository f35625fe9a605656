"""Session: one object owning the whole Chunks-and-Tasks machinery.

The paper's matrix library (made explicit in the follow-up "Chunks and
Tasks Matrix Library 2.0", arXiv:2011.11762) exposes matrices as objects
whose algebra hides chunk identifiers and task registration.  A
:class:`Session` is this repo's rendering of that front door: it owns the
:class:`~repro_torch.core.tasks.CTGraph`, the leaf engine, the runtime
:class:`~repro_torch.runtime.scheduler.Scheduler` (and through it the
:class:`~repro_torch.core.chunks.ChunkStore`), the
:class:`~repro_torch.core.tasks.CostModel` and the chunk placement policy, so a
paper experiment is a handful of lines::

    from repro_torch import Session

    sess = Session(engine="torch", placement="parent", leaf_n=64, bs=8)
    A = sess.from_dense(a)
    B = sess.from_dense(b)
    sess.simulate(p=8)                      # build phase places inputs
    C = A @ B                               # one CUDA kernel launch per wave
    rep = sess.simulate(fresh_stats=True)   # measured multiply phase
    C.to_dense(), rep.max_bytes_received, rep.crit.length_s

Every operation lowers through the expression IR (:mod:`repro_torch.api.expr`)
onto the documented internal layer — the ``qt_*`` free functions of
:mod:`repro_torch.core.quadtree` / :mod:`repro_torch.core.multiply` — and adds no
graph structure of its own, so the paper's eq (1) task counts and the
numpy/torch engine equivalence pin it exactly.  ``lazy=True`` defers
lowering to readback and reuses compiled :class:`~repro_torch.api.plan.Plan`
objects — the front end that iterative algorithms (SP2 purification)
need::

    sess = Session(lazy=True)
    X = sess.from_dense(x0, name="X")
    plan = sess.compile(X @ X)
    Y = plan.run()                  # lowers + executes once
    Y = plan.run(X=Y)               # rebinds + replays: zero new tasks
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Callable, Optional, Union

import numpy as np

from repro_torch.core.engine import LeafEngine
from repro_torch.core.quadtree import (QTParams, qt_from_coo, qt_from_dense,
                                 qt_structure_fp)
from repro_torch.core.tasks import CostModel, CTGraph
from repro_torch.obs.metrics import MetricSet, from_engine_stats, from_sim_report
from repro_torch.obs.tracer import Tracer, as_tracer
from repro_torch.runtime.scheduler import PLACEMENTS

from .expr import (Expr, Transpose, expr_inputs, expr_upper, fingerprint,
                   rewrite)
from .lru import LRUCache
from .matrix import Matrix
from .plan import Plan, lower

#: default bound on a session's compiled-plan cache (LRU; 0 = unbounded)
PLAN_CACHE_CAP = 64

#: accepted spellings of the scheduler placement policies: every canonical
#: policy name passes through, plus shorthand aliases
PLACEMENT_ALIASES = {p: p for p in PLACEMENTS}
PLACEMENT_ALIASES.update({"parent": "parent-worker", "rr": "round-robin"})

#: engine spec strings resolvable by :func:`repro_torch.core.engine.make_engine`
ENGINE_NAMES = ("numpy", "torch", "mesh")


def _normalize_placement(placement: Optional[str]) -> Optional[str]:
    if placement is None:
        return None
    try:
        return PLACEMENT_ALIASES[placement]
    except KeyError:
        raise ValueError(
            f"unknown placement {placement!r}; pick one of "
            f"{sorted(set(PLACEMENT_ALIASES.values()))}") from None


def _validate_engine(engine: Any) -> Any:
    """Fail fast on bad engine specs instead of at first leaf task."""
    if isinstance(engine, LeafEngine):
        return engine
    if isinstance(engine, str) and engine in ENGINE_NAMES:
        return engine
    raise ValueError(
        f"unknown leaf engine spec: {engine!r}; pick one of "
        f"{ENGINE_NAMES} or pass a LeafEngine instance")


class Session:
    """Owns graph + engine + simulator behind one constructor.

    Parameters
    ----------
    engine : ``"torch"`` (default: deferred, cross-leaf batched waves
        through the CUDA kernels; needs a CUDA device and raises at the
        first leaf task without one — pass ``TorchEngine(device="cpu")``
        to run the kernels' plain PyTorch versions instead), ``"numpy"``
        (the host reference, immediate; only when asked for), ``"mesh"``
        (waves sharded over the ranks of a torch.distributed group,
        :class:`~repro_torch.launch.mesh_exec.MeshEngine`; a world of one
        without a process group) or a
        :class:`~repro_torch.core.engine.LeafEngine` instance.  One stateful
        engine instance serves one session/graph; rebinding raises
        :class:`~repro_torch.core.engine.EngineRebindError`.  Unknown specs
        raise here, not at the first leaf task.
    placement : default chunk placement for :meth:`simulate` —
        ``"parent"``/``"parent-worker"`` (the paper's locality model),
        ``"round-robin"`` or ``"random"``.
    leaf_n, bs : quadtree leaf dimension and leaf-internal blocksize used
        for matrices built by this session (per-matrix overrides via the
        ``leaf_n=``/``bs=`` kwargs of the constructors).
    p : default simulated worker count for :meth:`simulate`.
    tau : default SpAMM truncation threshold for ``A @ B`` /
        :meth:`Matrix.multiply` on plain operands (DESIGN.md §5).  The
        default 0.0 multiplies exactly; a positive tau prunes every
        recursive product with ``||A'||_F ||B'||_F < tau`` and records a
        worst-case error bound on the result
        (:attr:`~repro_torch.api.matrix.Matrix.error_bound`).  The symmetric
        task programs are untruncated and *raise* under a nonzero
        effective tau (see :meth:`Matrix.sym_square`).
    lazy : ``False`` (default) lowers every operator call immediately —
        the classic eager facade.  ``True`` builds expression DAGs
        instead; readback (or :meth:`compile`) lowers them through the
        rewrite pipeline and caches the compiled :class:`Plan` for
        re-execution (DESIGN.md §6).
    cost, cache_bytes, seed, dedup : forwarded to the runtime
        :class:`~repro_torch.runtime.scheduler.Scheduler` / chunk store
        (``dedup=True`` enables content-hash chunk deduplication).
    trace : ``False`` (default) keeps the shared no-op tracer — zero
        recording, no behavioural change.  ``True`` records structured
        spans (:mod:`repro_torch.obs.tracer`) across the whole stack:
        ``session.simulate``, ``plan.compile``/``plan.run``,
        ``engine.wave``, ``kernel.dispatch``, ``collective.ppermute``.
        A :class:`~repro_torch.obs.tracer.Tracer` instance is also accepted
        (shared across sessions).  See also :meth:`tracing` for scoped
        tracing and :meth:`metrics` for the unified counter view
        (DESIGN.md §8).
    plan_cache_cap : bound on the compiled-plan cache (LRU eviction past
        it; ``0`` = unbounded).  Hit/miss/eviction counters appear in
        :meth:`metrics` once the cache has been touched.
    """

    def __init__(self, engine: Any = "torch",
                 placement: str = "parent-worker", leaf_n: int = 64,
                 bs: int = 8, p: Optional[int] = None,
                 cost: Optional[CostModel] = None,
                 cache_bytes: int = 1 << 62, seed: int = 0,
                 dedup: bool = False, tau: float = 0.0,
                 lazy: bool = False, trace: Any = False,
                 plan_cache_cap: int = PLAN_CACHE_CAP):
        self.graph = CTGraph(engine=_validate_engine(engine))
        self.tracer = as_tracer(trace)
        self.graph.tracer = self.tracer
        self.leaf_n = leaf_n
        self.bs = bs
        self.placement = _normalize_placement(placement)
        self.p = p
        self.cost = cost
        self.cache_bytes = cache_bytes
        self.seed = seed
        self.dedup = dedup
        self.tau = float(tau)
        self.lazy = bool(lazy)
        self._sched = None
        # node id -> materialised-transpose node id, shared by all handles
        # so a reused lazy .T registers its task program only once
        self._transpose_cache: dict[Optional[int], Optional[int]] = {}
        # compiled-plan cache: structural fingerprint -> Plan (DESIGN.md
        # §6).  LRU-bounded: under serving traffic unbounded growth is a
        # leak; hits/misses/evictions surface through metrics()
        self._plans: LRUCache = LRUCache(cap=plan_cache_cap)
        # serving hook: callables fired with each freshly compiled Plan
        # (the cross-session SharedPlanCache registers through this, so
        # recompile=True successors land there too — DESIGN.md §9)
        self._plan_observers: list = []
        # node id -> quadtree structure fingerprint (structure is final at
        # registration, so entries never go stale)
        self._structfp: dict[Optional[int], str] = {}
        # input root node id -> user-chosen plan slot name
        self._input_names: dict[int, str] = {}
        # every live Matrix handle and compiled Plan of this session, the
        # evicted plans a caller still holds included: free leaves the
        # chunks they read
        self._handles: weakref.WeakSet = weakref.WeakSet()
        self._live_plans: weakref.WeakSet = weakref.WeakSet()
        # most recent SimReport (feeds Session.metrics)
        self._last_report = None

    def __repr__(self) -> str:
        eng = getattr(self.graph, "_engine_spec", None)
        eng = getattr(eng, "name", eng)
        mode = ", lazy" if self.lazy else ""
        return (f"Session(engine={eng!r}, placement={self.placement!r}, "
                f"leaf_n={self.leaf_n}, bs={self.bs}{mode}, "
                f"tasks={len(self.graph.nodes)})")

    # -- matrix construction ------------------------------------------------
    def params_for(self, n: int, leaf_n: Optional[int] = None,
                   bs: Optional[int] = None) -> QTParams:
        """The :class:`QTParams` chunk this session uses for dimension n."""
        return QTParams(n, leaf_n or self.leaf_n, bs or self.bs)

    def from_dense(self, a: np.ndarray, upper: bool = False,
                   tol: float = 0.0, leaf_n: Optional[int] = None,
                   bs: Optional[int] = None,
                   name: Optional[str] = None) -> Matrix:
        """Build a quadtree matrix from a dense array (task program).

        ``name`` labels the matrix as a rebindable plan input slot:
        ``plan.run(name=new_values)`` (DESIGN.md §6).
        """
        a = np.asarray(a)
        params = self.params_for(a.shape[0], leaf_n, bs)
        nid = qt_from_dense(self.graph, a, params, upper=upper, tol=tol)
        return self._register_input(nid, params, upper, name)

    def from_pattern(self, rows: np.ndarray, cols: np.ndarray, n: int,
                     value_fn: Optional[Callable] = None,
                     upper: bool = False, leaf_n: Optional[int] = None,
                     bs: Optional[int] = None,
                     name: Optional[str] = None) -> Matrix:
        """Build from nonzero coordinates without a dense detour
        (:func:`~repro_torch.core.quadtree.qt_from_coo`)."""
        params = self.params_for(n, leaf_n, bs)
        nid = qt_from_coo(self.graph, rows, cols, params,
                          value_fn=value_fn, upper=upper)
        return self._register_input(nid, params, upper, name)

    def zeros(self, n: int, upper: bool = False,
              leaf_n: Optional[int] = None, bs: Optional[int] = None
              ) -> Matrix:
        """The all-zero (NIL) matrix of dimension n."""
        return Matrix(self, None, self.params_for(n, leaf_n, bs),
                      upper=upper)

    def _register_input(self, nid: Optional[int], params: QTParams,
                        upper: bool, name: Optional[str]) -> Matrix:
        if name is not None and nid is not None:
            self._input_names[nid] = name
        return Matrix(self, nid, params, upper=upper, name=name)

    # -- expression lowering (both modes) -----------------------------------
    def _run_expr(self, e: Expr, params: QTParams) -> Matrix:
        """Eager mode: rewrite + lower one operator call immediately.

        Emits the identical ``qt_*`` registrations as the pre-IR facade:
        single-op expressions are already in normal form, transposes
        materialise through the session-wide cache, and a top-level
        transpose peels into the handle's lazy flag instead of a task.
        """
        upper = expr_upper(e)
        e = rewrite(e)
        t = False
        while isinstance(e, Transpose):
            t, e = not t, e.a
        reports: list = []
        n0 = len(self.graph.nodes)
        nid = lower(self, e, params, reports, use_transpose_cache=True)
        trunc = reports[0] if len(reports) == 1 else None
        m = Matrix(self, nid, params, t=t, upper=upper, trunc=trunc)
        # the producing program's nid range: lets Session.free release the
        # program's intermediate chunks (consumed multiply/add partials),
        # not just the result tree
        m._prog = range(n0, len(self.graph.nodes))
        return m

    def compile(self, target: Union[Matrix, Expr]) -> Plan:
        """Compile an expression into a cached, re-executable :class:`Plan`.

        ``target`` is a lazy (pending) :class:`Matrix` — the natural way
        to spell an expression, ``sess.compile(X @ X + C)`` — or a raw
        :class:`~repro_torch.api.expr.Expr`.  Plans are cached by structural
        fingerprint (expression shape + QTParams + operand sparsity
        structure + per-node tau) *plus the identity of the bound
        inputs*: compiling the same expression twice returns the same
        plan, and running it again replays the recorded program with
        rebound inputs instead of registering new tasks.  Input identity
        is part of the key so that no plan ever rebinds a matrix the
        caller didn't pass to ``run`` — values move between iterations
        only through explicit ``plan.run(name=...)`` bindings.
        """
        if isinstance(target, Matrix):
            if target.session is not self:
                raise ValueError("compile: matrix belongs to a different "
                                 "Session")
            if target._expr is None:
                raise ValueError(
                    "compile: matrix is already materialised — build the "
                    "expression in a Session(lazy=True), e.g. "
                    "plan = sess.compile(X @ X)")
            e, params = target._expr, target.params
        elif isinstance(target, Expr):
            e = target
            inputs = _first_input_n(e)
            params = self.params_for(inputs)
        else:
            raise TypeError(f"compile: expected a Matrix or Expr, got "
                            f"{type(target)!r}")
        plan, _ = self._compile_expr(e, params)
        return plan

    def _fingerprint_expr(self, e: Expr, params: QTParams
                          ) -> tuple[str, str, list, bool, bool, Expr]:
        """Normalise + fingerprint an expression for plan-cache lookup.

        Returns ``(key, struct_key, slot_nids, t, upper, normal_form)``
        where ``struct_key`` covers the expression shape, tau, QTParams
        and operand *structures* (input-identity-free — the cross-session
        serving cache groups by it) and ``key`` appends the identity of
        the bound inputs (this session's full plan-cache key).
        """
        upper = expr_upper(e)
        e = rewrite(e)
        t = False
        while isinstance(e, Transpose):
            t, e = not t, e.a
        key, slot_nids = fingerprint(e, self._structure_fp, params)
        struct_key = f"{key}:t{int(t)}"
        # input identity is part of the cache key: a structurally
        # identical expression over *different* matrices compiles its own
        # program instead of silently rebinding (and overwriting) the
        # first plan's input chunks
        key = f"{struct_key}:b{tuple(slot_nids)}"
        return key, struct_key, slot_nids, t, upper, e

    def _compile_expr(self, e: Expr, params: QTParams
                      ) -> tuple[Plan, list]:
        key, struct_key, slot_nids, t, upper, expr = \
            self._fingerprint_expr(e, params)
        plan = self._plans.get(key)
        if plan is None:
            names: list = []
            for slot, nid in enumerate(slot_nids):
                name = self._input_names.get(nid, f"x{slot}")
                while name in names:    # keep every slot name bindable
                    name += "_"
                names.append(name)
            plan = Plan(self, expr, params, key, slot_nids, names,
                        struct_key=struct_key)
            plan.out_t = t
            plan.out_upper = upper
            self._plans.put(key, plan)
            self._live_plans.add(plan)
            for observer in list(self._plan_observers):
                observer(plan)
        return plan, slot_nids

    def _force(self, m: Matrix) -> None:
        """Materialise a pending lazy matrix through the plan cache.

        The cache key includes input identity, so a hit always has the
        expression's own inputs bound: forcing replays the recorded
        program against their *current* values and never rebinds (or
        overwrites) anything.  The plan's output chunks are refreshed in
        place, so handles from earlier runs of the same plan observe the
        new values.
        """
        plan, _ = self._compile_expr(m._expr, m.params)
        out = plan._run({})
        m.node, m._t, m._trunc = out.node, out._t, out._trunc
        m._expr = None

    def _structure_fp(self, nid: Optional[int]) -> str:
        fp = self._structfp.get(nid)
        if fp is None:
            fp = self._structfp[nid] = qt_structure_fp(self.graph, nid)
        return fp

    # -- execution ----------------------------------------------------------
    def flush(self) -> None:
        """Run deferred leaf-engine waves (readback does this for you).

        While tracing, the tracer's ``step`` advances once the engine has
        drained: the spans of the next product carry the next step."""
        self.graph.flush()
        if self.tracer.enabled:
            self.tracer.step += 1

    @property
    def scheduler(self):
        """The session's runtime simulator (created on first use)."""
        if self._sched is None:
            from repro_torch.runtime.scheduler import Scheduler
            self._sched = Scheduler(cost=self.cost,
                                    cache_bytes=self.cache_bytes,
                                    seed=self.seed, dedup=self.dedup)
        return self._sched

    def simulate(self, p: Optional[int] = None,
                 placement: Optional[str] = None,
                 fresh_stats: bool = False, faults: Any = None):
        """Replay all not-yet-simulated tasks on the virtual cluster.

        The scheduler is persistent across calls (chunk placements from an
        earlier phase — e.g. the task program that *built* the inputs —
        carry over, paper §7).  ``fresh_stats=True`` zeroes the per-worker
        counters first so the returned
        :class:`~repro_torch.runtime.scheduler.SimReport` isolates this phase's
        communication.  ``p``/``placement`` default to the session's and
        are pinned by the first call.  To re-simulate a compiled plan's
        fixed program use :meth:`Plan.simulate`, which replays through
        :meth:`~repro_torch.runtime.scheduler.Scheduler.replay`.

        ``faults`` injects a deterministic
        :class:`~repro_torch.runtime.recovery.FaultSchedule` (or an iterable of
        :class:`~repro_torch.runtime.recovery.FaultEvent`) into this run's
        simulated timeline — worker deaths, stragglers, elastic
        join/leave — with lineage or replication recovery (DESIGN.md
        §10).  The returned report carries the recovery counters
        (``tasks_recomputed``, ``chunks_lost``, ``bytes_rereplicated``).
        Dead workers stay out of the pool for later calls.
        """
        sched = self.scheduler
        if fresh_stats:
            sched.reset_stats()
        placement = _normalize_placement(placement)
        if sched.store is None:     # first run: session defaults apply
            p = p or self.p
            placement = placement or self.placement
        if self.tracer.enabled:
            with self.tracer.span("session.simulate", track="session",
                                  p=p, placement=placement,
                                  fresh_stats=fresh_stats) as sp:
                rep = sched.run(self.graph, n_workers=p,
                                placement=placement, faults=faults)
                sp.set(makespan_s=rep.makespan,
                       tasks=sum(rep.tasks_per_worker),
                       bytes_received=sum(rep.bytes_received))
        else:
            rep = sched.run(self.graph, n_workers=p, placement=placement,
                            faults=faults)
        self._last_report = rep
        return rep

    def reset_stats(self) -> None:
        """Zero per-worker comm counters; placements persist (§7)."""
        self.scheduler.reset_stats()

    def free(self, matrix: Matrix) -> int:
        """Release a consumed matrix's chunks: its host values and its
        placements in the simulated store.

        Long iterative runs otherwise keep every intermediate, both in the
        task graph on the host and in the
        :class:`~repro_torch.core.chunks.ChunkStore`.  The freed nodes are
        the matrix's quadtree and the task program that produced it (the
        consumed multiply/add partials that are not part of the result
        tree).  The engine's :meth:`~repro_torch.core.engine.LeafEngine.
        free_chunks` hook runs first; then the scheduler frees every chunk
        it placed for them and drops their placement entries; then the
        graph lets go of their host chunks and of the block-pair lists a
        truncated multiply froze on them
        (:meth:`~repro_torch.core.tasks.CTGraph.drop_values`), so the
        nodes keep their ids, kinds and counts but read as NIL.  Returns
        the number of owned bytes released from the simulated store.

        The freed matrix must not be read again.  Whatever else can
        still be read keeps its host chunks (the simulator releases the
        placements of every freed node, as before):

        * every tree another live :class:`Matrix` handle reads, a pending
          lazy expression's inputs included: another handle on the same
          tree (its ``.T``) keeps all of it;
        * nodes older than the matrix's own program: an add with a NIL
          quadrant shares its operand's subtrees, which stay the
          operand's;
        * every node a compiled :class:`Plan` owns: its program and its
          bound input trees (a replay reads and rewrites them in place);
        * transposes materialised through the session-wide cache, whose
          placements are kept as well;
        * with ``dedup=True``, the nodes the simulator has not run yet:
          their content decides its dedup hits.  A dedup'd chunk that
          another registration shares stays in the store, which holds its
          own reference.

        A freed node still produced its chunk: a later :meth:`simulate`
        places a stand-in of the same size
        (:meth:`~repro_torch.core.tasks.CTGraph.placed`), so the report
        is the one the loop gives without :meth:`free`.  While tracing,
        the chunks and bytes let go of add to the counters
        ``graph.freed_chunks`` and ``graph.freed_bytes``.
        """
        if not isinstance(matrix, Matrix):
            raise TypeError(f"free: expected a Matrix, got {type(matrix)!r}")
        if matrix._expr is not None:
            return 0                    # never materialised: nothing placed
        from .plan import _subtree_nids
        g = self.graph
        targets = set(_subtree_nids(g, matrix.node))
        targets.update(matrix._prog or ())
        # materialised transposes are shared session-wide through
        # _transpose_cache (an eager program that registered one may not
        # be its only consumer): keep their chunks and placements
        for tnid in self._transpose_cache.values():
            if tnid is not None:
                targets.difference_update(_subtree_nids(g, tnid))
        # engine hook *before* the scheduler: an engine that keeps
        # device-resident state for these leaves (MeshEngine, the mesh
        # executor) must drop it even when nothing was ever simulated.
        # TorchEngine copies every wave's result back to the host and
        # keeps no device buffer, so its hook is the no-op base
        if g._engine is not None:
            g._engine.free_chunks(g, targets)
        released = 0
        sched = self._sched
        if sched is not None and sched.store is not None:
            before = sum(s.owned_bytes for s in sched.store.stats)
            sched.release(g, targets)
            # alias entries (identifier copies) pointing into the freed
            # chunks.  This scans the full placement map — an identity
            # test, deliberately not a chunk-id test, so dedup-shared cids
            # owned by other live matrices keep their entries;
            # O(placements) per free is fine for the simulator's
            # bookkeeping.
            for k in [k for k, _ in list(sched.placement.items())
                      if g.resolve(k) in targets]:
                sched.placement.pop(k, None)
            released = before - sum(s.owned_bytes
                                    for s in sched.store.stats)
        lo = matrix._prog.start if matrix._prog is not None else 0
        drop = {nid for nid in targets if nid >= lo}
        drop -= self._read_elsewhere(matrix, lo)
        if self.dedup:
            drop = sched.simulated(drop) if sched is not None else set()
        chunks, nbytes = g.drop_values(drop)
        self.tracer.add("graph.freed_chunks", chunks)
        self.tracer.add("graph.freed_bytes", nbytes)
        return released

    def _read_elsewhere(self, matrix: Matrix, lo: int) -> set:
        """Nodes from ``lo`` on that something other than ``matrix`` still
        reads: the trees of the session's other live handles and of the
        inputs of pending lazy expressions, and each compiled plan's
        program and bound input trees.  A tree is whole once its
        registration returns, so one rooted before ``lo`` holds no node
        from ``lo`` on and is not walked."""
        from .plan import _subtree_nids
        keep: set = set()
        roots: set = set()
        for h in list(self._handles):
            if h is matrix:
                continue
            if h._expr is None:
                roots.add(h.node)
            else:
                roots.update(x.nid for x in expr_inputs(h._expr))
        for plan in list(self._live_plans):
            roots.update(plan.input_nids)
            if plan.nodes is not None:
                keep.update(range(max(lo, plan.nodes.start),
                                  plan.nodes.stop))
        for nid in roots:
            if nid is not None and nid >= lo:
                keep.update(_subtree_nids(self.graph, nid))
        return keep

    # -- reporting ----------------------------------------------------------
    def task_counts(self) -> dict[str, int]:
        """Tasks registered so far, by kind (paper Figs 3-4 inputs)."""
        return self.graph.count_kinds()

    def tasks_per_level(self) -> dict[int, int]:
        """Multiplication tasks per quadtree level (eq (1) family)."""
        from repro_torch.core.multiply import count_tasks_per_level
        return count_tasks_per_level(self.graph)

    @property
    def n_multiply_tasks(self) -> int:
        from repro_torch.core.multiply import total_multiply_tasks
        return total_multiply_tasks(self.graph)

    @property
    def n_add_tasks(self) -> int:
        from repro_torch.core.multiply import total_add_tasks
        return total_add_tasks(self.graph)

    @property
    def flops(self) -> float:
        from repro_torch.core.multiply import total_flops
        return total_flops(self.graph)

    def engine_stats(self) -> dict:
        """Leaf-engine report (batched waves, padding, kernel wall time)."""
        self.flush()
        return self.graph.engine.stats()

    # -- observability (DESIGN.md §8) ----------------------------------------
    @contextlib.contextmanager
    def tracing(self, tracer: Optional[Tracer] = None):
        """Record spans for the enclosed block only.

        >>> sess = Session(engine="torch")
        >>> with sess.tracing() as tr:          # doctest: +SKIP
        ...     C = (A @ B).to_dense()
        >>> tr.find("engine.wave")              # doctest: +SKIP

        The previous tracer (usually the shared no-op) is restored on
        exit, even on error.
        """
        prev = self.tracer
        tr = tracer if tracer is not None else Tracer()
        self._set_tracer(tr)
        try:
            yield tr
        finally:
            self._set_tracer(prev)

    def _set_tracer(self, tracer) -> None:
        self.tracer = tracer
        self.graph.tracer = tracer

    def metrics(self) -> list[MetricSet]:
        """Unified counter view of everything this session observed.

        One :class:`~repro_torch.obs.metrics.MetricSet` per active source, all
        in the same ``{name, unit, per_worker[], total}`` schema: the
        leaf engine's wave counters, the task graph's size ("graph":
        ``held_bytes``, ``freed_bytes`` and ``nodes``) and, when
        :meth:`simulate` has run, the simulator's per-worker counters
        from the most recent report (identical values to the legacy
        :class:`~repro_torch.runtime.scheduler.SimReport` fields).
        """
        out = [from_engine_stats(self.engine_stats()), self._graph_metrics()]
        if self._last_report is not None:
            out.append(from_sim_report(self._last_report))
        pc = self._plan_cache_metrics()
        if pc is not None:
            out.append(pc)
        pr = self._plan_recompile_metrics()
        if pr is not None:
            out.append(pr)
        return out

    def _graph_metrics(self) -> MetricSet:
        """The task graph's size: its nodes, the bytes of the chunks
        they hold (``CTGraph.held_bytes``) and the bytes :meth:`free` has
        let go of (``CTGraph.freed_bytes``, cumulative)."""
        ms = MetricSet(source="graph")
        ms.add("held_bytes", "B", [self.graph.held_bytes])
        ms.add("freed_bytes", "B", [self.graph.freed_bytes])
        ms.add("nodes", "count", [len(self.graph.nodes)])
        return ms

    def _plan_cache_metrics(self) -> Optional[MetricSet]:
        """Plan-cache counters, or None while the cache is untouched.

        Aggregates the session cache with every cached plan's bounded
        ``_recompiled`` successor cache (the other LRU this session
        owns).  Eager sessions never touch either, so their metrics()
        sources are unchanged.
        """
        c = self._plans.counters()
        for plan in self._plans.values():
            rc = plan._recompiled.counters()
            for k in ("hits", "misses", "evictions"):
                c[k] += rc[k]
            c["size"] += rc["size"]
        if c["hits"] + c["misses"] + c["evictions"] == 0:
            return None
        ms = MetricSet(source="plan-cache")
        for k in ("hits", "misses", "evictions", "size"):
            ms.add(f"plan_cache_{k}", "count", [c[k]])
        return ms

    def _plan_recompile_metrics(self) -> Optional[MetricSet]:
        """Recompile-successor counters, or None while nothing recompiled.

        Changing-sparsity iterations run through
        ``plan.run(recompile=True)``: a *hit* is a structure-mismatch
        run served by an already-compiled successor's zero-task replay,
        a *miss* had to compile a fresh plan.  Mirrors the "plan-cache"
        source so drifting-structure chains are observable per session.
        """
        hits = sum(p._succ_hits for p in self._plans.values())
        misses = sum(p._succ_misses for p in self._plans.values())
        if hits + misses == 0:
            return None
        ms = MetricSet(source="plan-recompile")
        ms.add("plan_recompile_hits", "count", [hits])
        ms.add("plan_recompile_misses", "count", [misses])
        return ms


def _first_input_n(e: Expr) -> int:
    inputs = expr_inputs(e)
    if not inputs:
        raise ValueError("compile: expression has no inputs")
    return inputs[0].n
