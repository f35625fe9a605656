"""Plan: a compiled, cached, re-executable expression program.

``Session.compile`` lowers a rewritten :class:`~repro_torch.api.expr.Expr`
through the documented ``qt_*`` task programs exactly once; the resulting
:class:`Plan` then *replays* — ``plan.run(X=...)`` rebinds leaf inputs in
place (:func:`~repro_torch.core.quadtree.qt_rebind_dense` /
:func:`~repro_torch.core.quadtree.qt_rebind_from`) and re-executes the recorded
program through the leaf engine (:func:`~repro_torch.core.multiply.qt_replay`)
**without registering a single task**.  That is the shape iterative
electronic-structure work needs (density-matrix purification executes the
same multiply structure every iteration): per-iteration graph size is
constant instead of linear in the iteration count.

Key invariants:

* **Pinned lowering** — for a single-op expression the emitted task
  program is identical (kinds, levels, schedule) to the eager facade's,
  which is itself pinned graph-for-graph to the free-function layer.
* **Structural identity** — a plan's cache key
  (:func:`~repro_torch.api.expr.fingerprint`) covers the expression shape,
  per-node tau, the session's QTParams, every input's quadtree
  structure, and the identity of the bound inputs (so no plan is ever
  implicitly rebound to a matrix the caller didn't pass to ``run``).
  Rebinding therefore never changes the program: new values must live
  on the compiled structure (enforced by the rebind hooks).
* **Frozen truncation** — a plan compiled with ``tau > 0`` freezes its
  pruning decisions (subtree prunes are baked into the graph, leaf
  block-pair lists are recorded on the nodes): replays re-run the same
  program, and :attr:`reports` keeps the compile-time
  :class:`~repro_torch.core.multiply.TruncationReport`\\ s.
* **In-place refresh** — a replay refreshes the *existing* output chunks.
  Handles returned by earlier runs of the same plan observe the new
  values (double-buffer semantics); read out what you need (a trace, a
  dense copy) before re-running.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core.multiply import (TruncationReport, qt_add, qt_multiply,
                                 qt_replay, qt_scale, qt_sym_multiply,
                                 qt_sym_square, qt_syrk, qt_transpose)
from repro_torch.core.quadtree import (PlanStructureError, qt_invalidate_caches,
                                 qt_rebind_dense, qt_rebind_from)
from repro_torch.core.triangular import qt_inv_chol, qt_tri_solve
from repro_torch.obs.metrics import from_engine_stats, from_truncation

from .expr import (Add, Expr, Input, InvChol, MatMul, Scale, SymMul,
                   SymSquare, Syrk, Transpose, TriSolve)
from .lru import LRUCache

__all__ = ["Plan", "PlanStructureError", "lower"]

#: recompile successors kept per plan (changing-sparsity iterations walk
#: a handful of structures; anything past this is a cold recompile again)
RECOMPILED_CAP = 8


def lower(session, expr: Expr, params, reports: list,
          use_transpose_cache: bool = True) -> Optional[int]:
    """Emit the ``qt_*`` task program of a rewritten expression.

    Common subexpressions are lowered once (the memo below — structural
    equality of the frozen dataclasses makes this a dict lookup).
    ``use_transpose_cache=True`` (eager mode) shares materialised
    transposes session-wide, preserving the eager facade's semantics;
    plan compilation passes False so every task the plan depends on is
    inside its replayed node range.
    """
    g = session.graph
    memo: dict[Expr, Optional[int]] = {}
    local_tcache: dict[Optional[int], Optional[int]] = {}

    def transpose_of(src: Optional[int]) -> Optional[int]:
        cache = (session._transpose_cache if use_transpose_cache
                 else local_tcache)
        if src not in cache:
            cache[src] = qt_transpose(g, params, src)
        return cache[src]

    def go(e: Expr) -> Optional[int]:
        if e in memo:
            return memo[e]
        if isinstance(e, Input):
            nid = e.nid
        elif isinstance(e, Transpose):
            nid = transpose_of(go(e.a))
        elif isinstance(e, Scale):
            nid = qt_scale(g, params, go(e.a), e.alpha)
        elif isinstance(e, Add):
            nid = go(e.terms[0])
            for t in e.terms[1:]:
                nid = qt_add(g, params, nid, go(t))
        elif isinstance(e, MatMul):
            na, nb = go(e.a), go(e.b)
            if e.tau > 0.0:
                rep = TruncationReport(tau=e.tau)
                reports.append(rep)
                nid = qt_multiply(g, params, na, nb, ta=e.ta, tb=e.tb,
                                  tau=e.tau, trunc=rep)
            else:
                reports.append(TruncationReport(tau=0.0))
                nid = qt_multiply(g, params, na, nb, ta=e.ta, tb=e.tb)
        elif isinstance(e, SymSquare):
            nid = qt_sym_square(g, params, go(e.a))
        elif isinstance(e, Syrk):
            nid = qt_syrk(g, params, go(e.a), trans=e.trans)
        elif isinstance(e, SymMul):
            nid = qt_sym_multiply(g, params, go(e.s), go(e.b), side=e.side)
        elif isinstance(e, InvChol):
            nid = qt_inv_chol(g, params, go(e.a))
        elif isinstance(e, TriSolve):
            nid = qt_tri_solve(g, params, go(e.r), go(e.b))
        else:
            raise TypeError(f"not an Expr: {e!r}")
        memo[e] = nid
        return nid

    return go(expr)


class Plan:
    """One compiled expression: lowered once, re-executable forever.

    Instances come from :meth:`Session.compile` (or implicitly from lazy
    readback) and are cached on the session by structural fingerprint.
    """

    def __init__(self, session, expr: Expr, params, key: str,
                 input_nids: list, names: list,
                 struct_key: Optional[str] = None):
        self.session = session
        self.expr = expr                    # rewritten normal form
        self.params = params
        self.key = key
        # input-identity-free prefix of ``key`` (fingerprint + tau): the
        # serving layer's cross-session cache groups replicas by it
        self.struct_key = struct_key if struct_key is not None else key
        self.input_nids = list(input_nids)  # slot order
        self.input_names = list(names)      # slot order, unique
        self.reports: list[TruncationReport] = []
        self.out_node: Optional[int] = None
        self.out_t = False
        self.out_upper = False
        self.nodes: Optional[range] = None  # registered nid range
        self.n_runs = 0
        # observability (DESIGN.md §8): wall time of the lowering run vs
        # each zero-task replay, and the engine wave-log index at first
        # execution so profile() can slice out this plan's waves
        self.compile_s = 0.0
        self.replay_s: list[float] = []
        self._wave0 = 0
        # plans this one delegated to after a structure-mismatch rebind
        # with recompile=True, keyed by their cache key: later runs with
        # the same new structure replay these instead of compiling again
        # (LRU-bounded — unbounded growth was a leak under serving
        # traffic; evictions roll up into Session.metrics())
        self._recompiled: LRUCache = LRUCache(cap=RECOMPILED_CAP)
        # successor reuse counters (Session.metrics() "plan-recompile"):
        # a hit is a structure-mismatch run served by an already-compiled
        # successor's zero-task replay; a miss had to compile fresh
        self._succ_hits = 0
        self._succ_misses = 0

    def __repr__(self) -> str:
        state = (f"tasks={len(self.nodes)}" if self.nodes is not None
                 else "uncompiled")
        return (f"Plan(inputs={self.input_names}, runs={self.n_runs}, "
                f"{state}, key={self.key[:10]})")

    # -- execution ----------------------------------------------------------
    def run(self, *, recompile: bool = False, flush: bool = True,
            **bindings) -> "Matrix":
        """Execute the program; returns the result handle.

        Keyword arguments rebind input slots by name (the ``name=`` given
        at matrix construction, else ``x0``, ``x1``, ... in first-use
        order) to a dense array or a structure-identical :class:`Matrix`
        — feeding a plan's own output back into an input slot is the
        supported iteration idiom (values are copied before the replay
        starts).  The first run lowers and executes the task program;
        every later run registers **zero tasks**: it refreshes the leaf
        inputs in place and replays the recorded program through the
        leaf engine.

        A rebound value whose sparsity structure differs from the
        structure frozen into this plan's fingerprint raises
        :class:`~repro_torch.core.quadtree.PlanStructureError` (replaying the
        frozen program — including any truncation pair lists — against a
        different structure would silently drop contributions).
        ``recompile=True`` handles the changing-sparsity regime instead:
        on a structure mismatch the expression is recompiled through the
        session's plan cache against fresh inputs built from the new
        values, and that plan runs.  ``recompile`` and ``flush`` are
        reserved keywords: they are never treated as input-slot names.

        ``flush=False`` (deferred engines only) leaves the replayed
        numeric work pending on the engine instead of dispatching it —
        the serving front end runs several plans this way, then coalesces
        their compatible ready waves into shared batched kernel calls
        (DESIGN.md §9).  The returned handle must not be read back until
        the graph is flushed.
        """
        unknown = set(bindings) - set(self.input_names)
        if unknown:
            raise ValueError(
                f"unknown plan input(s) {sorted(unknown)}; this plan binds "
                f"{self.input_names}")
        by_slot = {self.input_names.index(k): v for k, v in bindings.items()}
        return self._run(by_slot, recompile=recompile, flush=flush)

    def _run(self, by_slot: dict, recompile: bool = False,
             flush: bool = True) -> "Matrix":
        tr = self.session.tracer
        if not tr.enabled:
            return self._run_inner(by_slot, recompile, None, flush)
        with tr.span("plan.run", track="plan", key=self.key[:10],
                     bound=len(by_slot)) as sp:
            return self._run_inner(by_slot, recompile, sp, flush)

    def _run_inner(self, by_slot: dict, recompile: bool,
                   sp, flush: bool = True) -> "Matrix":
        tr = self.session.tracer
        try:
            with tr.span("plan.rebind", track="plan", slots=len(by_slot)):
                self._rebind(by_slot)
        except PlanStructureError:
            # rebinds are atomic (validate-then-fill), so the compiled
            # inputs are untouched and this plan stays runnable
            if not recompile:
                raise
            return self._recompile_run(by_slot, flush=flush)
        first = self.nodes is None
        t0 = time.perf_counter()
        if first:
            with tr.span("plan.compile", track="plan") as csp:
                self._execute_first(flush=flush)
                csp.set(tasks=len(self.nodes))
            self.compile_s = time.perf_counter() - t0
        else:
            with tr.span("plan.replay", track="plan",
                         tasks=len(self.nodes)):
                self._replay(flush=flush)
            self.replay_s.append(time.perf_counter() - t0)
        if sp is not None:
            sp.set(first=first, tasks=len(self.nodes))
        self.n_runs += 1
        return self._handle()

    def _recompile_run(self, by_slot: dict, flush: bool = True
                       ) -> "Matrix":
        """Compile the same expression against fresh inputs and run it.

        Each bound slot whose value no longer fits the compiled structure
        gets a *new* input matrix built from the new values (dense
        arrays through ``Session.from_dense``; Matrix handles bind
        directly), the expression is rewritten over the substituted
        inputs, and the session's plan cache takes it from there — same
        structure next iteration hits the recompiled plan's fast replay
        path.  This plan itself is left fully intact.
        """
        sess = self.session
        # a prior recompile may already hold the new structure: rebinding
        # into it is a zero-task replay, so try those before building
        # fresh inputs (keeps iterating with recompile=True from growing
        # a new plan per call)
        for succ in list(self._recompiled.values()):
            try:
                out = succ._run(by_slot, flush=flush)
                self._succ_hits += 1
                return out
            except PlanStructureError:
                continue
        self._succ_misses += 1
        subst: dict = {}
        for slot, value in by_slot.items():
            if value is None:
                continue
            old = self.input_nids[slot]
            if hasattr(value, "_ensure"):       # a Matrix handle
                value._ensure()
                if value.session is not sess:
                    raise ValueError(
                        "plan rebind: operand belongs to a different "
                        "Session")
                if value.params != self.params:
                    raise ValueError(
                        "plan recompile: operand quadtree parameters "
                        f"{value.params} differ from the plan's "
                        f"{self.params}")
                if value._t:
                    m = sess.from_dense(value.to_dense(),
                                        upper=value.upper,
                                        leaf_n=self.params.leaf_n,
                                        bs=self.params.bs)
                else:
                    m = value
            else:
                m = sess.from_dense(np.asarray(value),
                                    leaf_n=self.params.leaf_n,
                                    bs=self.params.bs)
            # keep the user-facing slot name on the substituted input so
            # the recompiled plan binds the same names
            if m.node is not None:
                sess._input_names.setdefault(m.node,
                                             self.input_names[slot])
            subst[old] = Input(m.node, self.params.n, upper=m.upper)
        e = _substitute_inputs(self.expr, subst)
        if self.out_t:
            e = Transpose(e)    # restore the transpose peeled at compile
        plan, _ = sess._compile_expr(e, self.params)
        self._recompiled.setdefault(plan.key, plan)
        return plan._run({}, flush=flush)

    def _rebind(self, by_slot: dict) -> None:
        g = self.session.graph
        sched = self.session._sched
        for slot, value in by_slot.items():
            dst = self.input_nids[slot]
            if value is None:
                continue
            if hasattr(value, "_ensure"):       # a Matrix handle
                value._ensure()
                if value.session is not self.session:
                    raise ValueError(
                        "plan rebind: operand belongs to a different "
                        "Session")
                if value._t:
                    # honor a pending lazy transpose by rebinding the
                    # transposed values (dense detour: no tasks, and the
                    # support check still applies)
                    qt_rebind_dense(g, dst, value.to_dense(), self.params)
                elif value.node == dst:
                    continue                    # already the bound input
                else:
                    qt_rebind_from(g, dst, value.node)
            else:
                qt_rebind_dense(g, dst, np.asarray(value), self.params)
            if sched is not None and sched.store is not None:
                # the simulator's per-chunk-id caches (norms, dedup
                # fingerprints) are keyed to the old bytes; the rebound
                # subtree's values changed under those ids
                for nid in _subtree_nids(g, dst):
                    sched.store.invalidate_content(
                        sched.placement.get(nid))

    def _execute_first(self, flush: bool = True) -> None:
        sess, g = self.session, self.session.graph
        if flush:
            # drain earlier pending waves so the wave-log slice profile()
            # reads contains only this plan's work (a deferred-batch
            # caller forgoes that isolation to keep other plans' waves
            # coalescible)
            g.flush()
        self._wave0 = len(getattr(g.engine, "_waves", ()))
        n0 = len(g.nodes)
        self.out_node = lower(sess, self.expr, self.params, self.reports,
                              use_transpose_cache=False)
        self.nodes = range(n0, len(g.nodes))

    def _replay(self, flush: bool = True) -> None:
        g = self.session.graph
        qt_invalidate_caches(g, self.nodes)
        qt_replay(g, self.nodes, flush=flush)
        sched = self.session._sched
        if sched is not None and sched.store is not None:
            # program chunks already placed by an earlier simulate now
            # hold refreshed values: retire their store-side norm/dedup
            # caches (Scheduler.replay re-registers them at the next
            # Plan.simulate, but other registrations may come first)
            for nid in self.nodes:
                sched.store.invalidate_content(sched.placement.get(nid))

    def _handle(self) -> "Matrix":
        from .matrix import Matrix
        # eager parity: a handle carries a TruncationReport only when the
        # *producing op* is the multiply — the root of the plan's
        # rewritten expression.  Reports are appended post-order, so the
        # root multiply's is last.  Per-product reports and the summed
        # direct bound stay readable on the plan (reports / error_bound).
        trunc = None
        if isinstance(self.expr, MatMul) and self.reports:
            trunc = self.reports[-1]
        return Matrix(self.session, self.out_node, self.params,
                      t=self.out_t, upper=self.out_upper, trunc=trunc)

    # -- simulation ----------------------------------------------------------
    def simulate(self, p: Optional[int] = None,
                 placement: Optional[str] = None, fresh_stats: bool = True,
                 faults=None):
        """Simulate the plan's program on the session's virtual cluster.

        Both passes are restricted to the plan's own task program (plus
        any genuinely unsimulated prerequisites, e.g. an input build
        that was never simulated): other pending work — another
        compiled-but-not-yet-simulated plan, unrelated eager tasks —
        keeps its own report instead of being charged to this one.  The
        first call simulates the program; later calls *replay* it
        through :meth:`~repro_torch.runtime.scheduler.Scheduler.replay` — the
        program's previous chunk placements are released and the same
        tasks run again, so each iteration of a purification loop gets
        its own communication/makespan report against persistent input
        placements.

        ``faults`` injects a deterministic fault schedule into this
        pass's simulated timeline (DESIGN.md §10) — the simulator never
        touches task values, so a failure-injected replay returns
        bitwise-identical results to the failure-free one.
        """
        sess, g = self.session, self.session.graph
        sched = sess.scheduler
        if self.nodes is None:
            raise RuntimeError("plan not executed yet: call run() first")
        if fresh_stats:
            sched.reset_stats()
        if sched.has_simulated(self.nodes):
            return sched.replay(g, self.nodes, faults=faults)
        from .session import _normalize_placement
        placement = _normalize_placement(placement)
        if sched.store is None:     # first-ever run: session defaults
            p = p or sess.p
            placement = placement or sess.placement
        return sched.run(g, n_workers=p, placement=placement,
                         only=sched.unsimulated_closure(g, self.nodes),
                         faults=faults)

    # -- reporting -----------------------------------------------------------
    def profile(self) -> dict:
        """Per-plan profile in the unified metrics schema (DESIGN.md §8).

        Returns compile vs replay wall time, the engine waves this plan's
        program produced (batch sizes, padding waste, bytes packed), and
        the unified counter sets — the leaf engine's (measured per-device
        bytes under ``engine="mesh"``) plus one per truncated product.
        Works on any engine; the wave list is empty on the immediate
        numpy backend.
        """
        sess = self.session
        sess.flush()
        stats = sess.graph.engine.stats()
        waves = list(stats.get("wave_log", ()))[self._wave0:]
        metric_sets = [from_engine_stats(stats)]
        metric_sets += [from_truncation(r) for r in self.reports
                        if r.tau > 0.0]
        return {
            "schema": 1,
            "plan": self.key[:16],
            "inputs": list(self.input_names),
            "runs": self.n_runs,
            "n_tasks": self.n_tasks,
            "compile_s": self.compile_s,
            "replay_s": list(self.replay_s),
            "waves": [{
                "kernel": w.get("kernel"), "bs": w.get("bs"),
                "tasks": w.get("tasks"), "pairs": w.get("pairs"),
                "padded_pairs": w.get("padded_pairs"),
                "padding_waste": (
                    (w.get("padded_pairs", 0) - w.get("pairs", 0))
                    / max(w.get("padded_pairs", 0), 1)),
                "bytes_packed": w.get("bytes_packed"),
                "wall_s": w.get("wall_s"),
            } for w in waves],
            "metrics": [ms.to_dict() for ms in metric_sets],
        }

    @property
    def n_tasks(self) -> int:
        """Tasks the compiled program registered (constant across runs)."""
        return 0 if self.nodes is None else len(self.nodes)

    @property
    def error_bound(self) -> float:
        """Summed worst-case truncation bound of all truncated products."""
        return sum(r.error_bound for r in self.reports)


def _substitute_inputs(e: Expr, subst: dict) -> Expr:
    """Rebuild an expression with some Input nids replaced.

    ``subst`` maps old input nid -> replacement :class:`Input`.  Nodes
    are immutable value types, so an untouched subtree is returned
    as-is (and common subexpressions stay shared by value equality).
    """
    if isinstance(e, Input):
        return subst.get(e.nid, e)
    if isinstance(e, Transpose):
        return Transpose(_substitute_inputs(e.a, subst))
    if isinstance(e, Scale):
        return Scale(e.alpha, _substitute_inputs(e.a, subst))
    if isinstance(e, Add):
        return Add(tuple(_substitute_inputs(t, subst) for t in e.terms))
    if isinstance(e, MatMul):
        return MatMul(_substitute_inputs(e.a, subst),
                      _substitute_inputs(e.b, subst),
                      ta=e.ta, tb=e.tb, tau=e.tau)
    if isinstance(e, SymSquare):
        return SymSquare(_substitute_inputs(e.a, subst))
    if isinstance(e, Syrk):
        return Syrk(_substitute_inputs(e.a, subst), trans=e.trans)
    if isinstance(e, SymMul):
        return SymMul(_substitute_inputs(e.s, subst),
                      _substitute_inputs(e.b, subst), e.side)
    if isinstance(e, InvChol):
        return InvChol(_substitute_inputs(e.a, subst))
    if isinstance(e, TriSolve):
        return TriSolve(_substitute_inputs(e.r, subst),
                        _substitute_inputs(e.b, subst))
    raise TypeError(f"not an Expr: {e!r}")


def _subtree_nids(g, nid: Optional[int]) -> list:
    """Resolved node ids of every chunk in a quadtree (root included)."""
    out: list[int] = []

    def walk(n: Optional[int]) -> None:
        chunk = g.value_of(n)
        if chunk is None:
            return
        out.append(g.resolve(n))
        if chunk.children is not None:
            for c in chunk.children:
                walk(c)

    walk(nid)
    return out
