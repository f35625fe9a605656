"""The port's plan server (``repro_torch.serve``) against the reference's.

Mirrors ``tests/test_serve.py`` class by class on the port, for the numpy
engine and for ``engine="torch"`` on the CPU (``ServeConfig(device=
"cpu")``: the kernels' plain PyTorch versions), and adds what only the
port has to hold:

* results within ``TOL`` of the reference's numpy-engine server for the
  same seeded requests, and equal to its Pallas-engine server's on one
  small multiply (interpret mode costs 0.5-5 s a wave, so only one);
* coalesced results equal to serial results bitwise on the torch engine;
* the counts of the committed ``BENCH_serve.json`` (hit rate, solo and
  merged waves, task counts) reproduced exactly;
* one ``TorchEngine`` per pooled session, engines on different devices
  never sharing a wave, and ``PlanServer()`` refusing to start without a
  card unless asked for the CPU.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serve as ref_serve  # noqa: E402
from repro_torch import Session  # noqa: E402
from repro_torch.api.lru import LRUCache  # noqa: E402
from repro_torch.core.engine import TorchEngine  # noqa: E402
from repro_torch.serve import (AdmissionError, PlanServer,  # noqa: E402
                               Request, ServeConfig, SharedPlanCache,
                               WaveCoalescer)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LEAF, BS = 16, 4
TOL = dict(atol=1e-4, rtol=1e-4)    # torch packs float32; numpy is float64
ENGINES = ["numpy", "torch"]


def _mats(n=32, k=3, seed=0):
    rng = np.random.default_rng(seed)
    return {f"M{i}": rng.standard_normal((n, n)) for i in range(k)}


def _x0(n=32, seed=1):
    """A dense symmetric iterate with eigenvalues in [0, 1]."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, n))
    h = (h + h.T) / 2
    w, v = np.linalg.eigh(h)
    return v @ np.diag((w.max() - w) / (w.max() - w.min())) @ v.T


def _server(engine="torch", **kw):
    cfg = dict(engine=engine, device="cpu", n_sessions=2, max_inflight=4,
               max_queue=32, leaf_n=LEAF, bs=BS)
    cfg.update(kw)
    return PlanServer(ServeConfig(**cfg))


def _serve_serial(mats, reqs, engine):
    """Each request served alone in a fresh single-slot server."""
    out = []
    for r in reqs:
        srv = _server(engine=engine, n_sessions=1, max_inflight=1)
        for nm, a in mats.items():
            srv.register(nm, a)
        t = srv.submit(r)
        srv.drain()
        assert t.done, t.error
        out.append(t.result)
    return out


def _serve(srv, mats, reqs):
    for nm, a in mats.items():
        srv.register(nm, a)
    tickets = [srv.submit(r) for r in reqs]
    srv.drain()
    for t in tickets:
        assert t.done, t.error
    return [t.result for t in tickets]


def _as_ref(req):
    """The reference's Request of the same fields."""
    return ref_serve.Request(kind=req.kind, a=req.a, b=req.b, x0=req.x0,
                             ne=req.ne, iters=req.iters)


class TestDeterminism:
    @pytest.mark.parametrize("engine", ENGINES)
    def test_interleaved_equals_serial(self, engine):
        """Concurrent batched serving returns the serial answers exactly."""
        mats = _mats()
        names = sorted(mats)
        reqs = [Request.multiply(a, b)
                for a in names for b in names][:6]
        serial = _serve_serial(mats, reqs, engine)
        for got, want in zip(_serve(_server(engine=engine), mats, reqs),
                             serial):
            np.testing.assert_array_equal(got, want)

    def test_coalesced_pinned_to_uncoalesced(self):
        """Cross-plan merged waves change nothing numerically (bitwise)."""
        mats = _mats()
        reqs = [Request.multiply("M0", "M1"), Request.multiply("M1", "M2"),
                Request.multiply("M2", "M0"), Request.multiply("M0", "M0")]
        serial = _serve_serial(mats, reqs, "torch")
        srv = _server(max_inflight=4)
        got = _serve(srv, mats, reqs)
        assert srv.coalescer.merged_waves > 0, \
            "expected cross-plan wave coalescing in a full batch"
        for g, want in zip(got, serial):
            np.testing.assert_array_equal(g, want)

    @pytest.mark.parametrize("engine", ENGINES)
    def test_sp2_matches_reference_recurrence(self, engine):
        """The per-ticket SP2 state machine equals the float64 recurrence."""
        n = 32
        x0 = _x0(n)
        ne, iters = 10.0, 3
        x = x0
        for _ in range(iters):
            tr = np.trace(x)
            assert abs(tr - ne) > 0.05, "degenerate test: trace at threshold"
            x = x @ x if tr > ne else 2 * x - x @ x
        srv = _server(engine=engine)
        srv.register("X", x0)
        t = srv.submit(Request.sp2("X", ne=ne, iters=iters))
        srv.drain()
        assert t.done, t.error
        np.testing.assert_allclose(t.result, x, atol=1e-3, rtol=1e-3)
        assert len(t.replay_s) >= iters     # one unit per polynomial term

    def test_mixed_workload_converges(self):
        """Multiply and sp2 requests interleave in one server."""
        n = 32
        mats = _mats(n)
        x0 = _x0(n)
        srv = _server()
        for nm, a in mats.items():
            srv.register(nm, a)
        srv.register("X", x0)
        tm = srv.submit(Request.multiply("M0", "M1"))
        ts = srv.submit(Request.sp2("X", ne=n / 2, iters=5))
        tm2 = srv.submit(Request.multiply("M2", "M2"))
        srv.drain()
        assert tm.done and ts.done and tm2.done
        np.testing.assert_allclose(tm.result, mats["M0"] @ mats["M1"], **TOL)
        np.testing.assert_allclose(tm2.result, mats["M2"] @ mats["M2"],
                                   **TOL)
        err = np.linalg.norm(ts.result @ ts.result - ts.result)
        assert err < np.linalg.norm(x0 @ x0 - x0)


class TestAgainstReference:
    """The same seeded requests through the reference's server."""

    @staticmethod
    def _workload():
        n = 32
        mats = _mats(n)
        rng = np.random.default_rng(7)
        mats["Z"] = np.triu(0.1 * rng.standard_normal((n, n)) + np.eye(n))
        mats["X"] = _x0(n)
        reqs = [Request.multiply("M0", "M1"), Request.multiply("M1", "M1"),
                Request.congruence("Z", "M2"),
                Request.sp2("X", ne=10.0, iters=3),
                Request.multiply("M2", "M0")]
        return mats, reqs

    @pytest.mark.parametrize("engine", ENGINES)
    def test_matches_reference_numpy_server(self, engine):
        mats, reqs = self._workload()
        want = _serve(ref_serve.PlanServer(ref_serve.ServeConfig(
            engine="numpy", n_sessions=2, max_inflight=4, max_queue=32,
            leaf_n=LEAF, bs=BS)), mats, [_as_ref(r) for r in reqs])
        srv = _server(engine=engine)
        got = _serve(srv, mats, reqs)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
        assert srv.counters["completed"] == len(reqs)
        assert srv.counters["failed"] == 0

    @pytest.mark.pallas
    def test_matches_reference_pallas_server(self):
        """One small multiply against the reference's Pallas engine:
        both pack float32, so the port agrees far inside ``TOL``."""
        mats = {k: v for k, v in _mats().items() if k in ("M0", "M1")}
        req = Request.multiply("M0", "M1")
        (want,) = _serve(ref_serve.PlanServer(ref_serve.ServeConfig(
            engine="pallas", n_sessions=1, max_inflight=1, leaf_n=LEAF,
            bs=BS)), mats, [_as_ref(req)])
        (got,) = _serve(_server(n_sessions=1, max_inflight=1), mats, [req])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


class TestAdmission:
    def test_queue_full_rejects_with_reason(self):
        mats = _mats()
        srv = _server(max_queue=3)
        for nm, a in mats.items():
            srv.register(nm, a)
        for _ in range(3):
            srv.submit(Request.multiply("M0", "M1"))
        with pytest.raises(AdmissionError) as ei:
            srv.submit(Request.multiply("M0", "M1"))
        assert ei.value.reason == "queue_full"
        assert srv.counters["rejected"] == 1
        srv.drain()                             # queued work still completes
        assert srv.counters["completed"] == 3

    def test_unknown_matrix_rejects(self):
        srv = _server()
        with pytest.raises(AdmissionError) as ei:
            srv.submit(Request.multiply("nope", "nada"))
        assert ei.value.reason == "unknown_matrix"

    def test_bad_request_rejects(self):
        srv = _server()
        srv.register("A", np.eye(32))
        with pytest.raises(AdmissionError) as ei:
            srv.submit(Request.sp2("A", ne=1.0, iters=0))
        assert ei.value.reason == "bad_request"
        with pytest.raises(AdmissionError) as ei:
            srv.submit(Request(kind="frobnicate"))
        assert ei.value.reason == "bad_request"

    def test_max_inflight_bounds_batch(self):
        mats = _mats()
        srv = _server(max_inflight=2)
        for nm, a in mats.items():
            srv.register(nm, a)
        tickets = [srv.submit(Request.multiply("M0", "M1"))
                   for _ in range(5)]
        srv.step()
        assert sum(1 for t in tickets if t.status != "queued") == 2
        srv.drain()
        assert all(t.done for t in tickets)


class TestCacheAccounting:
    def test_shared_cache_hits_after_warmup_zero_new_tasks(self):
        mats = _mats()
        srv = _server()
        for nm, a in mats.items():
            srv.register(nm, a)
        reqs = [Request.multiply("M0", "M1"), Request.multiply("M1", "M2")]
        for r in reqs:
            srv.submit(r)
        srv.drain()
        warm_tasks = srv.task_count()
        h0 = srv.cache.counters()["hits"]
        tickets = [srv.submit(r) for r in reqs * 3]
        srv.drain()
        assert all(t.done for t in tickets)
        assert srv.task_count() == warm_tasks, "warm requests registered tasks"
        assert srv.cache.counters()["hits"] > h0
        assert all(t.cache_hits >= 1 and t.cache_misses == 0
                   for t in tickets)

    def test_session_plan_cache_lru_bounds_and_metrics(self):
        sess = Session(engine="numpy", lazy=True, leaf_n=LEAF, bs=BS,
                       plan_cache_cap=2)
        rng = np.random.default_rng(0)
        ms = [sess.from_dense(rng.standard_normal((32, 32)))
              for _ in range(3)]
        plans = [sess.compile(m @ m) for m in ms]
        assert len(sess._plans) == 2            # LRU evicted the oldest
        assert sess._plans.evictions == 1
        assert sess.compile(ms[1] @ ms[1]) is plans[1]   # still cached
        pc = next(m for m in sess.metrics() if m.source == "plan-cache")
        assert pc["plan_cache_evictions"].total == 1
        assert pc["plan_cache_hits"].total >= 1

    def test_eager_session_metrics_unchanged(self):
        """Plan-cache counters appear only once the cache is touched."""
        sess = Session(engine="numpy", leaf_n=LEAF, bs=BS)
        a = sess.from_dense(np.eye(32))
        (a @ a).to_dense()
        assert [m.source for m in sess.metrics()] == ["engine:numpy",
                                                      "graph"]

    @pytest.mark.parametrize("engine", ENGINES)
    def test_recompiled_successors_register_in_shared_cache(self, engine):
        """plan.run(recompile=True) plans land in the cross-session cache."""
        eng = TorchEngine(device="cpu") if engine == "torch" else engine
        sess = Session(engine=eng, lazy=True, leaf_n=LEAF, bs=BS)
        cache = SharedPlanCache()
        cache.attach(sess)
        rng = np.random.default_rng(0)
        sparse = np.zeros((32, 32))
        sparse[:LEAF, :LEAF] = rng.standard_normal((LEAF, LEAF))
        x = sess.from_dense(sparse, name="X")
        plan = sess.compile(x @ x)
        plan.run()
        n_keys = len(cache)
        dense = rng.standard_normal((32, 32))
        out = plan.run(X=dense, recompile=True)
        np.testing.assert_allclose(out.to_dense(), dense @ dense,
                                   atol=1e-10 if engine == "numpy" else 1e-4)
        assert len(plan._recompiled) == 1
        succ = next(iter(plan._recompiled.values()))
        assert len(cache) == n_keys + 1
        assert succ in cache.lookup(succ.struct_key)

    def test_recompiled_cache_is_bounded(self):
        from repro_torch.api.plan import RECOMPILED_CAP
        n = 64                      # 4x4 leaf grid
        sess = Session(engine="numpy", lazy=True, leaf_n=LEAF, bs=BS)

        def leaf_pattern(pos, val):
            v = np.zeros((n, n))
            v[:LEAF, :LEAF] = val   # (0,0) always set: X @ X stays nonzero
            i, j = pos
            v[i * LEAF:(i + 1) * LEAF, j * LEAF:(j + 1) * LEAF] = val
            return v

        x = sess.from_dense(leaf_pattern((3, 3), 1.0), name="X")
        plan = sess.compile(x @ x)
        plan.run()
        for k in range(RECOMPILED_CAP + 3):
            pos = divmod(k + 1, 4)          # (0,1)..(3,0), never (0,0)/(3,3)
            plan.run(X=leaf_pattern(pos, 1.0 + k), recompile=True)
        assert len(plan._recompiled) == RECOMPILED_CAP

    def test_lru_cache_primitive(self):
        evicted = []
        c = LRUCache(cap=2, on_evict=lambda k, v: evicted.append(k))
        c.put("a", 1)
        c.put("b", 2)
        assert c.get("a") == 1                  # refreshes recency
        c.put("c", 3)                           # evicts b (LRU)
        assert evicted == ["b"]
        assert c.get("b") is None
        assert set(c.keys()) == {"a", "c"}
        assert c.counters() == {"hits": 1, "misses": 1, "evictions": 1,
                                "size": 2, "cap": 2}
        assert c.setdefault("a", 99) == 1       # no overwrite
        c2 = LRUCache(cap=0)                    # unbounded
        for i in range(100):
            c2.put(i, i)
        assert len(c2) == 100 and c2.evictions == 0

    def test_setdefault_refreshes_recency(self):
        c = LRUCache(cap=2)
        c.put("hot", 1)
        c.put("b", 2)
        assert c.setdefault("hot", 99) == 1     # touch via setdefault only
        c.put("c", 3)                           # cap pressure evicts LRU
        assert "hot" in c and "b" not in c
        assert c.peek("hot") == 1
        assert c.counters()["hits"] == 0 and c.counters()["misses"] == 0


class TestTargetedFlush:
    def test_rebind_flushes_only_entangled_leaves(self):
        """Rebinding one plan's input leaves another plan's waves pending."""
        sess = Session(engine=TorchEngine(device="cpu"), lazy=True,
                       leaf_n=LEAF, bs=BS)
        rng = np.random.default_rng(0)
        a = sess.from_dense(rng.standard_normal((32, 32)), name="A")
        b = sess.from_dense(rng.standard_normal((32, 32)), name="B")
        pa = sess.compile(a @ a)
        pb = sess.compile(b @ b)
        pa.run()
        pb.run()
        sess.flush()
        va = rng.standard_normal((32, 32))
        vb = rng.standard_normal((32, 32))
        out_a = pa.run(A=va, flush=False)
        eng = sess.graph.engine
        assert eng._pending, "replay should have deferred kernel work"
        n_pending = len(eng._pending)
        out_b = pb.run(B=vb, flush=False)
        assert len(eng._pending) > n_pending, \
            "rebinding an unrelated plan's input flushed foreign waves"
        sess.flush()
        np.testing.assert_allclose(out_a.to_dense(), va @ va, **TOL)
        np.testing.assert_allclose(out_b.to_dense(), vb @ vb, **TOL)

    def test_deferred_run_readback_correct(self):
        """flush=False + explicit flush computes the same values."""
        sess = Session(engine=TorchEngine(device="cpu"), lazy=True,
                       leaf_n=LEAF, bs=BS)
        rng = np.random.default_rng(0)
        v = rng.standard_normal((32, 32))
        x = sess.from_dense(v, name="X")
        plan = sess.compile(x @ x)
        ref = plan.run().to_dense()
        v2 = rng.standard_normal((32, 32))
        out = plan.run(X=v2, flush=False)
        sess.flush()
        np.testing.assert_allclose(out.to_dense(), v2 @ v2, **TOL)
        out3 = plan.run(X=v).to_dense()         # same values -> same bits
        np.testing.assert_array_equal(out3, ref)


def _deferred_squares(devices, seed=0):
    """One lazy torch session per device, each with ``X @ X`` compiled,
    run once and replayed deferred; returns (sessions, outs, values)."""
    rng = np.random.default_rng(seed)
    sessions = [Session(engine=TorchEngine(device=d), lazy=True, leaf_n=LEAF,
                        bs=BS) for d in devices]
    outs, vals = [], []
    for sess in sessions:
        v = rng.standard_normal((32, 32))
        x = sess.from_dense(v, name="X")
        p = sess.compile(x @ x)
        p.run()
        sess.flush()
        outs.append(p.run(X=v, flush=False))
        vals.append(v)
    return sessions, outs, vals


class TestCoalescerUnit:
    def test_coalescer_merges_across_sessions(self):
        """Two sessions' deferred waves become one fused dispatch."""
        sessions, outs, vals = _deferred_squares(["cpu", "cpu"])
        co = WaveCoalescer()
        assert co.flush([s.graph for s in sessions]) >= 1
        assert co.merged_waves >= 1, "same batch_key should merge"
        assert co.merged_tasks >= 2
        for out, v in zip(outs, vals):
            np.testing.assert_allclose(out.to_dense(), v @ v, **TOL)

    def test_engines_on_different_devices_never_share_a_wave(self):
        """Equal batch keys on two devices: one dispatch per device."""
        sessions, outs, vals = _deferred_squares(["cpu", "cpu:1"])
        keys = [set(s.graph.engine.ready_wave()) for s in sessions]
        assert keys[0] == keys[1], "same batch keys on both engines"
        co = WaveCoalescer()
        assert co.flush([s.graph for s in sessions]) == 2
        assert co.merged_waves == 0 and co.solo_waves == 2
        for out, v in zip(outs, vals):
            np.testing.assert_allclose(out.to_dense(), v @ v, **TOL)

    def test_coalescer_handles_numpy_graphs(self):
        """Immediate engines pass through the coalescer unharmed."""
        sess = Session(engine="numpy", leaf_n=LEAF, bs=BS)
        a = sess.from_dense(np.eye(32))
        c = a @ a
        co = WaveCoalescer()
        assert co.flush([sess.graph]) == 0
        np.testing.assert_array_equal(c.to_dense(), np.eye(32))


class TestServeObservability:
    def test_request_and_batch_spans(self):
        mats = _mats()
        srv = _server(trace=True)
        for nm, a in mats.items():
            srv.register(nm, a)
        t = srv.submit(Request.multiply("M0", "M1"))
        srv.drain()
        names = [s.name for s in srv.tracer.spans]
        assert "serve.batch" in names and "serve.wave" in names
        req_spans = [s for s in srv.tracer.spans
                     if s.name == "serve.request"]
        assert len(req_spans) == 1
        at = req_spans[0].attrs
        assert at["status"] == "done" and at["kind"] == "multiply"
        assert at["bytes"] == t.bytes > 0
        assert at["cache_misses"] == 1

    def test_server_metrics_schema(self):
        from repro_torch.obs.metrics import validate_metrics
        mats = _mats()
        srv = _server()
        for nm, a in mats.items():
            srv.register(nm, a)
        srv.submit(Request.multiply("M0", "M1"))
        srv.drain()
        sets = srv.metrics()
        sources = [m.source for m in sets]
        assert "serve" in sources and "serve-cache" in sources \
            and "serve-coalescer" in sources and "engine:torch" in sources
        for ms in sets:
            validate_metrics(ms.to_dict())
        serve = next(m for m in sets if m.source == "serve")
        assert serve["requests_completed"].total == 1

    def test_ticket_accounting(self):
        mats = _mats()
        srv = _server()
        for nm, a in mats.items():
            srv.register(nm, a)
        t1 = srv.submit(Request.multiply("M0", "M1"))
        srv.drain()
        t2 = srv.submit(Request.multiply("M0", "M1"))
        srv.drain()
        assert t1.cache_misses == 1 and t1.compile_s > 0
        assert t2.cache_hits == 1 and t2.compile_s == 0
        assert t1.latency_s > 0 and t2.latency_s > 0
        assert t2.replay_s and t1.batches == t2.batches == 1


class TestSolverServing:
    @pytest.mark.parametrize("engine", ENGINES)
    def test_congruence_request(self, engine):
        n = 32
        rng = np.random.default_rng(7)
        z = np.triu(0.1 * rng.standard_normal((n, n)) + np.eye(n))
        f = rng.standard_normal((n, n))
        f = (f + f.T) / 2
        srv = _server(engine=engine)
        srv.register("Z", z)
        srv.register("F", f)
        t = srv.submit(Request.congruence("Z", "F"))
        srv.drain()
        assert t.done, t.error
        np.testing.assert_allclose(t.result, z.T @ f @ z, **TOL)

    def test_congruence_unknown_matrix_rejected(self):
        srv = _server()
        with pytest.raises(AdmissionError) as ei:
            srv.submit(Request.congruence("Z", "F"))
        assert ei.value.reason == "unknown_matrix"

    @pytest.mark.parametrize("engine", ENGINES)
    def test_prewarm_zero_cold_compiles(self, engine):
        """prewarm=True compiles the iterate shapes in every pooled
        session at register(): SP2 traffic never pays a cold compile."""
        x0 = _x0()
        warm = _server(engine=engine, prewarm=True)
        warm.register("X", x0)
        tickets = [warm.submit(Request.sp2("X", ne=16.0, iters=3))
                   for _ in range(3)]
        warm.drain()
        assert all(t.done for t in tickets)
        assert warm.counters["cold_compiles"] == 0
        assert all(t.compile_s == 0.0 for t in tickets)
        cold = _server(engine=engine, prewarm=False)
        cold.register("X", x0)
        t = cold.submit(Request.sp2("X", ne=16.0, iters=3))
        cold.drain()
        assert t.done, t.error
        assert cold.counters["cold_compiles"] >= 1

    @pytest.mark.parametrize("engine", ENGINES)
    def test_prewarm_matches_cold_results(self, engine):
        x0 = _x0()
        results = []
        for pw in (False, True):
            srv = _server(engine=engine, prewarm=pw, n_sessions=1,
                          max_inflight=1)
            srv.register("X", x0)
            t = srv.submit(Request.sp2("X", ne=12.0, iters=4))
            srv.drain()
            assert t.done, t.error
            results.append(t.result)
        np.testing.assert_array_equal(results[0], results[1])


class TestPortServer:
    """What the port's server adds: its device and its engines."""

    def test_defaults_are_the_card(self):
        cfg = ServeConfig()
        assert cfg.engine == "torch" and cfg.device is None
        ref = ref_serve.ServeConfig()
        # every other knob keeps the reference's default
        for f in ("n_sessions", "max_inflight", "max_queue", "leaf_n", "bs",
                  "shared_cache_cap", "plan_cache_cap", "trace", "prewarm"):
            assert getattr(cfg, f) == getattr(ref, f), f

    def test_without_a_card_refuses_and_names_the_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PlanServer()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PlanServer(n_sessions=3, max_inflight=2)

    def test_each_session_owns_its_engine(self):
        srv = _server(n_sessions=3)
        engines = [s.graph._engine_spec for s in srv.sessions]
        assert all(type(e) is TorchEngine for e in engines)
        assert len({id(e) for e in engines}) == 3
        assert {e.device for e in engines} == {torch.device("cpu")}

    def test_numpy_spec_passes_through(self):
        srv = _server(engine="numpy", n_sessions=2)
        assert [s.graph._engine_spec for s in srv.sessions] == ["numpy"] * 2


def _bench_point(mats, reqs, max_inflight, n_sessions, reps):
    """``benchmarks/bench_serve.py::serve_point``'s protocol on the port's
    CPU torch engine: one warmup pass, then ``reps`` measured passes, the
    coalescer's counters summed over all of them."""
    srv = _server(n_sessions=n_sessions, max_inflight=max_inflight,
                  max_queue=max(len(reqs), 4))
    for name, a in mats.items():
        srv.register(name, a)
    for r in reqs:
        srv.submit(r)
    srv.drain()
    tasks = srv.task_count()
    c0 = srv.cache.counters()
    results = None
    for _ in range(reps):
        tickets = [srv.submit(r) for r in reqs]
        srv.drain()
        assert all(t.done for t in tickets)
        results = results or [t.result for t in tickets]
    assert srv.task_count() == tasks, "warm serving registered tasks"
    c = srv.cache.counters()
    hits, misses = c["hits"] - c0["hits"], c["misses"] - c0["misses"]
    return {"hit_rate": hits / max(hits + misses, 1), "tasks": tasks,
            "merged_waves": srv.coalescer.merged_waves,
            "solo_waves": srv.coalescer.solo_waves}, results


@pytest.fixture(scope="module")
def bench_serve():
    """The committed artifact, its request stream and its serial pass."""
    doc = json.loads((ROOT / "BENCH_serve.json").read_text())
    p = doc["params"]
    rng = np.random.default_rng(0)      # bench_serve.make_operands(seed=0)
    mats = {f"M{i}": rng.standard_normal((p["n"], p["n"]))
            for i in range(p["n_mats"])}
    names = sorted(mats)
    reqs = [Request.multiply(names[i % len(names)],
                             names[(i + 1) % len(names)])
            for i in range(p["requests"])]
    serial, results = _bench_point(mats, reqs, 1, 1, p["reps"])
    return doc, mats, reqs, serial, results


def test_bench_serve_serial_counts(bench_serve):
    doc, _, _, serial, _ = bench_serve
    want = doc["serial_reference"]
    assert doc["params"]["leaf_n"] == LEAF and doc["params"]["bs"] == BS
    assert serial == {k: want[k] for k in serial}
    assert serial["tasks"] == 29 and serial["solo_waves"] == 128


@pytest.mark.parametrize("max_inflight", [1, 2, 4, 8])
def test_bench_serve_counts_reproduce(bench_serve, max_inflight):
    """Hit rate, solo and merged waves and task counts of each committed
    row, exactly; the coalesced results equal the serial pass's bitwise."""
    doc, mats, reqs, _, serial_results = bench_serve
    p = doc["params"]
    row = next(r for r in doc["rows"] if r["max_inflight"] == max_inflight)
    got, results = _bench_point(mats, reqs, max_inflight, p["n_sessions"],
                                p["reps"])
    assert got == {k: row[k] for k in got}
    assert got["hit_rate"] == 1.0
    for g, want in zip(results, serial_results):
        np.testing.assert_array_equal(g, want)
