"""PlanServer: a concurrent front end over compiled, rebindable plans.

The ROADMAP's serving direction ("the same compiled plan substrate behind
a request front end") meets the paper's workloads here: clients submit
**multiply** requests (``C = A B`` over registered matrices) and **SP2
purification** requests (the iterated ``X²`` / ``2X − X²`` polynomial of
examples/torch_sp2_purification.py), and the server runs them *in batches*:

1. **Admission control** — a bounded queue; ``submit`` rejects with a
   typed reason (:class:`AdmissionError`) instead of buffering without
   bound.  ``max_inflight`` requests advance per batch.
2. **Shared plan cache** — request shapes are matched to compiled plan
   replicas by structural fingerprint
   (:class:`~repro_torch.serve.cache.SharedPlanCache`); a hit rebind-replays
   with **zero task registrations**, a miss compiles one replica in the
   least-busy session.  Every run rebinds *all* input slots with the
   request's effective values, so a replica compiled for one client's
   matrices safely serves another's.
3. **Cross-plan wave coalescing** — each in-flight request's unit runs
   with ``flush=False``, leaving its leaf kernel work deferred; one
   :class:`~repro_torch.serve.coalesce.WaveCoalescer` pass then merges the
   compatible waves of *all* in-flight plans — across sessions — into
   single fused kernel dispatches before results are read back.

Per-request accounting (queue_s, compile_s vs cache hits, replay_s,
bytes) lives on the :class:`Ticket`; ``serve.request`` / ``serve.batch``
spans flow through the span tracer, and :meth:`PlanServer.metrics`
returns the unified counter sets (DESIGN.md §8, §9).

Single-process by design: requests are *batched*, not threaded, so
results are deterministic — a serving batch computes bitwise the same
answers as running its requests serially (tests/test_torch_serve.py pins
this).  A multi-process front end and priority classes are the next
layer (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Optional

import numpy as np

from repro_torch.api.session import Session
from repro_torch.core.engine import TorchEngine, resolve_device
from repro_torch.obs.metrics import MetricSet
from repro_torch.obs.tracer import Span, as_tracer

from .cache import SharedPlanCache
from .coalesce import WaveCoalescer

__all__ = ["AdmissionError", "PlanServer", "Request", "ServeConfig",
           "Ticket"]


class AdmissionError(RuntimeError):
    """A request the server refused to queue; ``reason`` is machine-readable.

    Reasons: ``"queue_full"`` (depth limit reached — retry later),
    ``"unknown_matrix"`` (an operand name was never registered),
    ``"bad_request"`` (malformed parameters).
    """

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class Request:
    """One unit of client work; build via :meth:`multiply` / :meth:`sp2` /
    :meth:`congruence`."""
    kind: str                       # "multiply" | "sp2" | "congruence"
    a: str = ""                     # multiply/congruence: left operand name
    b: str = ""                     # multiply/congruence: right operand name
    x0: str = ""                    # sp2: starting-iterate name
    ne: float = 0.0                 # sp2: target trace (occupation)
    iters: int = 0                  # sp2: iteration count

    @classmethod
    def multiply(cls, a: str, b: str) -> "Request":
        """``C = A B`` over two registered matrices."""
        return cls(kind="multiply", a=a, b=b)

    @classmethod
    def congruence(cls, z: str, f: str) -> "Request":
        """``F_perp = Z^T F Z`` — the solver suite's basis change
        (:mod:`repro_torch.solvers.scf`), served as one two-multiply unit."""
        return cls(kind="congruence", a=z, b=f)

    @classmethod
    def sp2(cls, x0: str, ne: float, iters: int) -> "Request":
        """``iters`` SP2 steps from registered iterate ``x0``.

        Each step squares the iterate and keeps ``X²`` when
        ``trace(X) > ne``, else applies ``2X − X²`` — the trace-correcting
        purification polynomial (examples/torch_sp2_purification.py).
        """
        return cls(kind="sp2", x0=x0, ne=float(ne), iters=int(iters))


@dataclasses.dataclass
class Ticket:
    """Handle + accounting for one submitted request."""
    id: int
    request: Request
    status: str = "queued"          # queued | running | done | failed
    result: Optional[np.ndarray] = None
    error: Optional[str] = None
    # timings (perf_counter stamps; derived seconds below)
    t_submit: float = 0.0
    t_start: float = 0.0
    t_done: float = 0.0
    queue_s: float = 0.0            # submit -> first batch that ran it
    compile_s: float = 0.0          # plan lowering paid by this request
    replay_s: list = dataclasses.field(default_factory=list)  # per unit
    cache_hits: int = 0             # units served by an existing replica
    cache_misses: int = 0           # units that compiled a new replica
    bytes: int = 0                  # operand + result bytes moved
    batches: int = 0                # serving batches this request spanned

    @property
    def latency_s(self) -> float:
        """Submit-to-done wall time (0 until the request finishes)."""
        return max(self.t_done - self.t_submit, 0.0)

    @property
    def done(self) -> bool:
        return self.status == "done"


@dataclasses.dataclass
class ServeConfig:
    """Knobs of a :class:`PlanServer` (all have serving-scale defaults).

    ``device`` places the engines of ``engine="torch"``: ``None`` is the
    CUDA device, which must be present (the server raises without one,
    as :class:`~repro_torch.api.session.Session` does); ``"cpu"`` runs
    the kernels' plain PyTorch versions.  Other engine specs ignore it.
    """
    engine: Any = "torch"           # any Session engine spec
    device: Any = None              # "torch" engines: None (CUDA) or "cpu"
    n_sessions: int = 2             # worker sessions (one graph+engine each)
    max_inflight: int = 4           # requests advanced per batch
    max_queue: int = 16             # admission bound on queued requests
    leaf_n: int = 16                # quadtree leaf dimension
    bs: int = 4                     # leaf-internal blocksize
    shared_cache_cap: int = 128     # struct keys kept by the shared cache
    plan_cache_cap: int = 64        # per-session Session plan-cache bound
    trace: Any = False              # bool or a shared Tracer instance
    prewarm: bool = False           # compile plan replicas at register()


class PlanServer:
    """Batch-serving front end over a pool of lazy sessions."""

    def __init__(self, config: Optional[ServeConfig] = None, **overrides):
        cfg = config or ServeConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.config = cfg
        self.tracer = as_tracer(cfg.trace)
        self.sessions = [
            Session(engine=engine, lazy=True, leaf_n=cfg.leaf_n,
                    bs=cfg.bs, trace=self.tracer,
                    plan_cache_cap=cfg.plan_cache_cap)
            for engine in self._engines(cfg)]
        self.cache = SharedPlanCache(cap=cfg.shared_cache_cap)
        for s in self.sessions:
            self.cache.attach(s)
        self.coalescer = WaveCoalescer(tracer=self.tracer)
        self._matrices: dict[str, np.ndarray] = {}
        # (session index, name) -> template Matrix bound to compiled plans
        self._templates: dict[tuple, Any] = {}
        self._queue: deque[Ticket] = deque()
        self._inflight: list[Ticket] = []
        self._states: dict[int, dict] = {}      # ticket id -> unit state
        self._next_id = 0
        self._rr = 0                            # session round-robin tie-break
        self._busy: set = set()                 # id(plan) in use this batch
        self._fresh: list = []                  # (ticket, plan) compiled now
        self.counters = {"accepted": 0, "rejected": 0, "completed": 0,
                         "failed": 0, "batches": 0, "units": 0,
                         "cold_compiles": 0}

    @staticmethod
    def _engines(cfg: ServeConfig) -> list:
        """One engine spec per pooled session.

        A :class:`~repro_torch.core.engine.TorchEngine` holds one graph's
        deferred waves and refuses a second graph, so ``"torch"`` becomes
        one engine per session, all on ``cfg.device``; the coalescer then
        merges their waves.  Other specs pass through unchanged.
        """
        n = max(cfg.n_sessions, 1)
        if cfg.engine == "torch":
            device = resolve_device(cfg.device)
            return [TorchEngine(device=device) for _ in range(n)]
        return [cfg.engine] * n

    # -- registration ---------------------------------------------------------
    def register(self, name: str, array: np.ndarray) -> None:
        """Register a named matrix clients may reference in requests.

        Builds one quadtree template per session up front, so replica
        compiles and structural-fingerprint lookups are cheap everywhere.
        """
        a = np.asarray(array, dtype=np.float64)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"register: {name!r} must be square 2-D, "
                             f"got shape {a.shape}")
        self._matrices[name] = a
        for si, sess in enumerate(self.sessions):
            self._templates[(si, name)] = sess.from_dense(a, name=name)
        if self.config.prewarm:
            self._prewarm(name)

    def _prewarm(self, name: str) -> None:
        """Compile (and pay the deferred lowering of) one replica of the
        iterate shapes — ``sq`` (X X) and ``pol`` (2X − X²) — per pooled
        session, so the first SP2 request hits a warm replica everywhere.

        Lowering happens on a plan's *first run*, so prewarming executes
        each replica once against the registered values; the serving path
        then replays with zero task registrations and zero cold compiles
        (``counters["cold_compiles"]``).
        """
        a = self._matrices[name]
        for si in range(len(self.sessions)):
            for kind, ops in (("sq", [(name, a)]),
                              ("pol", [(name, a), (name + ".y", a)])):
                out = self._build_expr(si, kind, ops)
                plan = self.sessions[si].compile(out)
                if plan.nodes is None:
                    plan._run({})
                self.cache.register(plan)

    def _template(self, si: int, name: str, like: np.ndarray):
        """The (session, name) template, built from ``like`` on first use."""
        m = self._templates.get((si, name))
        if m is None:
            m = self.sessions[si].from_dense(like, name=name)
            self._templates[(si, name)] = m
        return m

    # -- admission ------------------------------------------------------------
    def submit(self, request: Request) -> Ticket:
        """Queue a request; returns its :class:`Ticket` or rejects."""
        names = ((request.a, request.b)
                 if request.kind in ("multiply", "congruence")
                 else (request.x0,))
        try:
            if request.kind in ("multiply", "congruence"):
                pass
            elif request.kind == "sp2":
                if request.iters < 1:
                    raise AdmissionError(
                        "bad_request", "sp2 request needs iters >= 1")
            else:
                raise AdmissionError(
                    "bad_request", f"unknown request kind {request.kind!r}")
            missing = [n for n in names if n not in self._matrices]
            if missing:
                raise AdmissionError(
                    "unknown_matrix",
                    f"operand(s) {missing} not registered; call "
                    f"server.register(name, array) first")
            if len(self._queue) >= self.config.max_queue:
                raise AdmissionError(
                    "queue_full",
                    f"queue depth {self.config.max_queue} reached "
                    f"({len(self._inflight)} in flight); retry later")
        except AdmissionError:
            self.counters["rejected"] += 1
            raise
        t = Ticket(id=self._next_id, request=request,
                   t_submit=time.perf_counter())
        self._next_id += 1
        self._queue.append(t)
        self.counters["accepted"] += 1
        return t

    # -- the batch loop -------------------------------------------------------
    def step(self) -> int:
        """Run one serving batch; returns the number of units executed.

        A batch admits queued requests up to ``max_inflight``, advances
        each in-flight request by one unit with deferred execution,
        coalesces the ready waves of every touched plan into shared
        kernel dispatches, then reads results back and completes
        finished requests.
        """
        now = time.perf_counter()
        while self._queue and len(self._inflight) < self.config.max_inflight:
            t = self._queue.popleft()
            t.status = "running"
            t.t_start = now
            t.queue_s = now - t.t_submit
            self._states[t.id] = self._init_state(t.request)
            self._inflight.append(t)
        if not self._inflight:
            return 0
        with self.tracer.span("serve.batch", track="serve",
                              inflight=len(self._inflight),
                              queued=len(self._queue)) as sp:
            units = self._run_batch()
            sp.set(units=units,
                   coalesced=self.coalescer.merged_waves)
        self.counters["batches"] += 1
        self.counters["units"] += units
        return units

    def drain(self) -> None:
        """Step until the queue and the in-flight set are both empty."""
        while self._queue or self._inflight:
            self.step()

    def _run_batch(self) -> int:
        self._busy.clear()
        self._fresh.clear()
        ran: list[tuple] = []       # (ticket, out handle, unit t0)
        for t in list(self._inflight):
            try:
                launched = self._launch_unit(t)
                if launched is not None:    # else: stalled on a busy replica
                    ran.append((t, *launched))
            except Exception as exc:        # noqa: BLE001 - per-request fault
                self._fail(t, exc)
        for t, plan in self._fresh:
            t.compile_s += plan.compile_s   # lowering paid during launch
        graphs = [s.graph for s in self.sessions]
        self.coalescer.flush(graphs)
        units = 0
        for t, out, t0 in ran:
            try:
                dense = out.to_dense()      # graph already flushed: no-op
                t.replay_s.append(time.perf_counter() - t0)
                t.bytes += int(dense.nbytes)
                t.batches += 1
                units += 1
                self._advance(t, dense)
            except Exception as exc:        # noqa: BLE001
                self._fail(t, exc)
        return units

    # -- unit state machines --------------------------------------------------
    def _init_state(self, req: Request) -> dict:
        if req.kind in ("multiply", "congruence"):
            return {}
        return {"x": self._matrices[req.x0], "it": 0, "phase": "sq",
                "y": None}

    def _launch_unit(self, t: Ticket) -> Optional[tuple]:
        """Run the ticket's next unit deferred; returns (out handle, t0).

        Returns ``None`` when every replica of the unit's structure is
        already serving another request this batch — the ticket stays
        in flight and retries next batch (replicas are per-plan mutable
        state, so two requests can never share one within a batch).
        """
        req, state = t.request, self._states[t.id]
        if req.kind in ("multiply", "congruence"):
            ops = self._distinct_ops([(req.a, self._matrices[req.a]),
                                      (req.b, self._matrices[req.b])])
            plan = self._acquire(
                t, "mm" if req.kind == "multiply" else "cong", ops)
        elif state["phase"] == "sq":
            ops = [(req.x0, state["x"])]
            plan = self._acquire(t, "sq", ops)
        else:
            ops = [(req.x0, state["x"]), (req.x0 + ".y", state["y"])]
            plan = self._acquire(t, "pol", ops)
        if plan is None:
            return None
        t0 = time.perf_counter()
        values = [v for _, v in ops]
        t.bytes += sum(int(v.nbytes) for v in values)
        bindings = {nm: values[i]
                    for i, nm in enumerate(plan.input_names)}
        return plan.run(flush=False, recompile=True, **bindings), t0

    def _advance(self, t: Ticket, dense: np.ndarray) -> None:
        req, state = t.request, self._states[t.id]
        if req.kind in ("multiply", "congruence"):
            return self._complete(t, dense)
        if state["phase"] == "sq":
            state["y"] = dense
            # SP2 branch on the iterate's trace vs the target occupation
            if np.trace(state["x"]) > req.ne:
                state["x"] = dense          # X <- X²
                state["it"] += 1
                state["phase"] = "sq"
            else:
                state["phase"] = "pol"      # X <- 2X − X² next unit
        else:
            state["x"] = dense
            state["y"] = None
            state["it"] += 1
            state["phase"] = "sq"
        if state["phase"] == "sq" and state["it"] >= req.iters:
            self._complete(t, state["x"])

    def _complete(self, t: Ticket, result: np.ndarray) -> None:
        t.result = result
        t.status = "done"
        t.t_done = time.perf_counter()
        self._inflight.remove(t)
        self._states.pop(t.id, None)
        self.counters["completed"] += 1
        self._request_span(t)

    def _fail(self, t: Ticket, exc: Exception) -> None:
        t.error = f"{type(exc).__name__}: {exc}"
        t.status = "failed"
        t.t_done = time.perf_counter()
        if t in self._inflight:
            self._inflight.remove(t)
        self._states.pop(t.id, None)
        self.counters["failed"] += 1
        self._request_span(t)

    def _request_span(self, t: Ticket) -> None:
        if not self.tracer.enabled:
            return
        ep = self.tracer.epoch
        self.tracer.spans.append(Span(
            "serve.request", t.t_submit - ep, t.t_done - ep, track="serve",
            attrs={"id": t.id, "kind": t.request.kind, "status": t.status,
                   "queue_s": t.queue_s, "compile_s": t.compile_s,
                   "replay_s": sum(t.replay_s), "bytes": t.bytes,
                   "cache_hits": t.cache_hits,
                   "cache_misses": t.cache_misses}))

    # -- replica acquisition --------------------------------------------------
    @staticmethod
    def _distinct_ops(ops: list) -> list:
        """Distinct (name, value) operands in first-use order.

        Mirrors the expression IR's slot semantics: ``A @ A`` fingerprints
        to one input slot, so the bound values list must dedup the same
        way.
        """
        out, seen = [], set()
        for name, v in ops:
            if name not in seen:
                seen.add(name)
                out.append((name, v))
        return out

    def _build_expr(self, si: int, kind: str, ops: list):
        """The unit's expression over session ``si``'s template matrices."""
        ms = [self._template(si, name, like=v) for name, v in ops]
        if kind == "mm":
            return ms[0] @ ms[-1]           # ms[-1]: A @ A dedups to one op
        if kind == "sq":
            return ms[0] @ ms[0]
        if kind == "cong":
            return (ms[0].T @ ms[-1]) @ ms[0]   # Z^T F Z (Z == F dedups)
        return 2.0 * ms[0] - ms[1]          # pol: 2X − X²

    def _acquire(self, t: Ticket, kind: str, ops: list):
        """A free plan replica for this unit's structure (compile on miss).

        Replicas are matched by input-identity-free ``struct_key``; every
        run rebinds all slots, so any replica fits.  A replica serves at
        most one request per batch (its input buffers and output chunks
        are per-plan state), so concurrent same-shape requests either
        spread across replicas in different sessions or queue behind one.
        """
        e0 = self._build_expr(0, kind, ops)
        sess0 = self.sessions[0]
        _, struct_key, _, _, _, _ = sess0._fingerprint_expr(
            e0._expr, e0.params)
        for plan in self.cache.lookup(struct_key):
            if id(plan) not in self._busy:
                self._busy.add(id(plan))
                t.cache_hits += 1
                return plan
        si = self._pick_session()
        plan = self.sessions[si].compile(self._build_expr(si, kind, ops))
        if id(plan) in self._busy:
            # the chosen session already holds this structure's replica
            # and it is serving another request this batch: running it
            # twice would overwrite its in-place buffers mid-flight, so
            # the unit stalls until the next batch frees the replica
            return None
        self.cache.register(plan)       # restore an LRU-evicted key too
        self._busy.add(id(plan))
        t.cache_misses += 1
        if plan.nodes is None:          # genuinely new: lowering pending
            self.counters["cold_compiles"] += 1
            self._fresh.append((t, plan))
        return plan

    def _pick_session(self) -> int:
        """Least busy session this batch; round-robin on ties."""
        load = [0] * len(self.sessions)
        for si, sess in enumerate(self.sessions):
            load[si] = sum(1 for p in sess._plans.values()
                           if id(p) in self._busy)
        lo = min(load)
        cands = [si for si, l in enumerate(load) if l == lo]
        self._rr += 1
        return cands[self._rr % len(cands)]

    # -- reporting ------------------------------------------------------------
    def task_count(self) -> int:
        """Total registered tasks across all sessions (warmup invariant:
        this number stops growing once every request shape has a replica)."""
        return sum(len(s.graph.nodes) for s in self.sessions)

    def metrics(self) -> list:
        """Unified counter sets: server, shared cache, coalescer, sessions."""
        ms = MetricSet(source="serve")
        for k, v in self.counters.items():
            ms.add(f"requests_{k}" if k in ("accepted", "rejected",
                                            "completed", "failed") else k,
                   "count", [v])
        out = [ms, self.cache.metrics(), self.coalescer.metrics()]
        for s in self.sessions:
            out.extend(s.metrics())
        return out

    def __repr__(self) -> str:
        return (f"PlanServer(sessions={len(self.sessions)}, "
                f"queued={len(self._queue)}, "
                f"inflight={len(self._inflight)}, "
                f"completed={self.counters['completed']})")
