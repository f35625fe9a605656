"""The port's runtime simulator against the reference's.

The same numpy inputs build the same task graphs in ``repro`` and
``repro_torch``; both simulators then replay them and must give the same
:class:`SimReport`: counts exactly (tasks, steals, bytes per worker,
pushed and fetched chunks, the recovery counters, every trace event's
worker and bytes), cost-model times to 1e-12 relative (the port sums in
the reference's order, so in practice they are equal too).  Work-stealing
victims and random placements come from each scheduler's own
``random.Random(seed)``, drawn in the same order.
"""
import json
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core.patterns import (banded_mask, divide_space_order,  # noqa: E402
                                 overlap_pairs, particle_cloud, random_mask,
                                 values_for_mask)
from repro_torch.core.engine import TorchEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, LEAF_N, BS = 64, 16, 4
PACKAGES = (repro, repro_torch)
PLACEMENTS = ("parent-worker", "round-robin", "random")
RECOVERIES = ("none", "replication", "lineage")


def _banded(seed=1, n=N, d=5):
    return values_for_mask(banded_mask(n, d), seed=seed, symmetric=True)


def _random(seed=1, n=N):
    return values_for_mask(random_mask(n, 0.1, seed=seed), seed=seed + 1)


def _s2_pairs():
    coords = particle_cloud(4, 3, seed=7)
    return overlap_pairs(coords, 4.0, order=divide_space_order(coords))


def _build(pkg, pattern, **kw):
    """A session with this pattern's inputs built; returns (session, op)
    where ``op()`` registers the multiply."""
    kw.setdefault("engine", "numpy")
    sess = pkg.Session(leaf_n=LEAF_N, bs=BS, **kw)
    if pattern == "s2":
        rows, cols = _s2_pairs()
        S = sess.from_pattern(rows, cols, N, upper=True)
        return sess, S.sym_square
    make = _banded if pattern == "banded" else _random
    A, B = sess.from_dense(make(1)), sess.from_dense(make(3))
    return sess, lambda: A @ B


def _report_fields(rep) -> dict:
    """Everything a SimReport carries, the trace and critical path
    included, as plain values."""
    d = {f: getattr(rep, f) for f in (
        "makespan", "bytes_received", "messages_received", "peak_owned",
        "tasks_per_worker", "busy_time", "steals", "n_workers",
        "placement", "bytes_pushed", "cache_hits", "dedup_hits",
        "flops_executed", "steal_time_s", "chunks_lost", "bytes_lost",
        "tasks_recomputed", "bytes_rereplicated", "chunks_recovered",
        "workers_failed", "fault_events")}
    d["to_dict"] = rep.to_dict()
    d["trace"] = rep.trace.to_dicts()
    d["crit"] = (rep.crit.work_s, rep.crit.length_s, rep.crit.path,
                 rep.crit.n_tasks)
    return d


def _assert_same(got, want, path="report"):
    """Counts equal, floats within 1e-12 relative, recursively."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12, abs=0.0), path
    else:
        assert type(got) is type(want) and got == want, path


def assert_same_report(got, want):
    _assert_same(_report_fields(got), _report_fields(want))


def _placements(sched) -> dict:
    return {nid: (cid.owner, cid.local) for nid, cid in
            sched.placement.items()}


def _measured(pkg, pattern, p, placement, **kw):
    """Build phase, then the multiply phase with fresh counters."""
    sess, op = _build(pkg, pattern, placement=placement, seed=3, **kw)
    sess.simulate(p=p)
    op()
    return sess, sess.simulate(fresh_stats=True)


@pytest.mark.parametrize("p", [4, 16])
@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("pattern", ["banded", "s2", "random"])
def test_sim_report_matches_reference(pattern, placement, p):
    (rs, want), (ps, got) = (_measured(pkg, pattern, p, placement)
                             for pkg in PACKAGES)
    assert_same_report(got, want)
    assert _placements(ps.scheduler) == _placements(rs.scheduler)
    assert got.n_tasks > 0 and got.steals >= 0
    if placement != "parent-worker":
        assert sum(got.bytes_pushed) > 0


@pytest.mark.parametrize("recovery", RECOVERIES)
def test_fault_schedule_matches_reference(recovery):
    """kill, slow, join and leave in one schedule, under each recovery
    policy (replication must already hold while the inputs are built)."""
    reps = []
    for pkg in PACKAGES:
        rec = pkg.runtime.recovery
        _, base = _measured(pkg, "banded", 4, "parent-worker")
        m0 = base.makespan
        sess, op = _build(pkg, "banded", placement="parent-worker", seed=3)
        build = (rec.FaultSchedule(events=[], recovery="replication",
                                   replicas=2)
                 if recovery == "replication" else None)
        sess.simulate(p=4, faults=build)
        op()
        faults = rec.FaultSchedule(
            events=[rec.slow(0.0, 1, 3.0), rec.join(0.3 * m0),
                    rec.kill(0.5 * m0, 2), rec.leave(0.6 * m0, 3)],
            recovery=recovery, replicas=2)
        reps.append(sess.simulate(fresh_stats=True, faults=faults))
    want, got = reps
    assert_same_report(got, want)
    assert got.workers_failed == [2] and got.n_workers == 5
    if recovery == "replication":
        assert got.bytes_rereplicated > 0
    else:
        assert got.tasks_recomputed > 0


def test_fresh_stats_and_replay_match_reference():
    """``Plan.simulate`` (first run, then ``Scheduler.replay`` of the fixed
    program) and ``Session.reset_stats``: equal reports throughout."""
    out = []
    for pkg in PACKAGES:
        sess = pkg.Session(engine="numpy", leaf_n=LEAF_N, bs=BS, p=4,
                           seed=5, lazy=True, placement="random")
        X = sess.from_dense(_banded(2), name="X")
        plan = sess.compile(X @ X + X)
        plan.run()
        first = plan.simulate(fresh_stats=True)
        n_nodes = len(sess.graph.nodes)
        plan.run(X=_banded(4))
        again = plan.simulate(fresh_stats=True)
        plan.run(X=_banded(6))
        third = plan.simulate(fresh_stats=True)
        assert len(sess.graph.nodes) == n_nodes       # replay: no new tasks
        assert third.n_tasks == again.n_tasks > 0     # the fixed program
        sess.reset_stats()
        assert all(s.bytes_received == 0 and s.bytes_pushed == 0
                   for s in sess.scheduler.store.stats)
        out.append((first, again, third, sess))
    (rf, ra, rt, rs), (pf, pa, pt, ps) = out
    assert_same_report(pf, rf)
    assert_same_report(pa, ra)
    assert_same_report(pt, rt)
    assert ps.scheduler.has_simulated(list(range(len(ps.graph.nodes))))
    assert _placements(ps.scheduler) == _placements(rs.scheduler)


def test_cluster_sim_matches_reference():
    """The historical front door over the scheduler, on bare task graphs."""
    reps = []
    for pkg in PACKAGES:
        from importlib import import_module
        q = import_module(f"{pkg.__name__}.core.quadtree")
        mul = import_module(f"{pkg.__name__}.core.multiply")
        tasks = import_module(f"{pkg.__name__}.core.tasks")
        params = q.QTParams(N, LEAF_N, BS)
        g = tasks.CTGraph(engine="numpy")
        sim = tasks.ClusterSim(4, seed=2)
        ra = q.qt_from_dense(g, _banded(1), params)
        rb = q.qt_from_dense(g, _random(3), params)
        sim.run(g)
        sim.reset_stats()
        mul.qt_multiply(g, params, ra, rb)
        reps.append((sim.run(g), tasks.SimResult, sim))
    (want, ref_cls, rsim), (got, port_cls, psim) = reps
    assert port_cls.__module__ == "repro_torch.runtime.scheduler"
    assert isinstance(got, port_cls)
    assert_same_report(got, want)
    assert _placements(psim) == _placements(rsim)
    assert psim.store.n_workers == 4 and psim.rng.random() == rsim.rng.random()


def test_critical_path_and_gantt_match_reference():
    reps = []
    for pkg in PACKAGES:
        from importlib import import_module
        trace = import_module(f"{pkg.__name__}.runtime.trace")
        sess, op = _build(pkg, "banded", placement="parent-worker", seed=0)
        sess.simulate(p=2)
        build = set(range(len(sess.graph.nodes)))
        op()
        rep = sess.simulate(fresh_stats=True)
        crit = trace.critical_path(sess.graph, rep.trace, done_before=build)
        empty = trace.critical_path(sess.graph, trace.Trace(2))
        reps.append((rep, crit, empty))
    (rr, rc, re), (pr, pc, pe) = reps
    for width in (40, 72):
        assert pr.trace.gantt(width=width) == rr.trace.gantt(width=width)
    assert pc.path == rc.path and pc.n_tasks == rc.n_tasks
    assert pc.to_dict() == rc.to_dict()
    assert pc.brent_bound(2) == rc.brent_bound(2)
    assert pe.to_dict() == re.to_dict() and pe.path == []
    assert pr.trace.schedule() == rr.trace.schedule()
    assert pr.trace.stolen_tasks() == rr.trace.stolen_tasks()


# -- the committed BENCH artifacts, run live through both packages ---------

def _comm_scaling_cell(pkg, p, placement):
    """``benchmarks/bench_comm_scaling.py::run_banded`` at its quick sizes
    (n_per 128, d 24, leaf_n 32, bs 8, seed 0)."""
    n = 128 * p
    a = values_for_mask(banded_mask(n, 24), seed=1, symmetric=True)
    sess = pkg.Session(leaf_n=32, bs=8, placement=placement, seed=0,
                       engine="numpy")
    A, B = sess.from_dense(a), sess.from_dense(a)
    sess.simulate(p=p)
    A @ B
    return n, sess.simulate(fresh_stats=True)


@pytest.mark.parametrize("cell", [(r["placement"], r["p"]) for r in
                                  json.loads((ROOT / "BENCH_comm_scaling.json")
                                             .read_text())["records"]],
                         ids=lambda c: f"{c[0]}-p{c[1]}")
def test_comm_scaling_rows_reproduce(cell):
    placement, p = cell
    doc = json.loads((ROOT / "BENCH_comm_scaling.json").read_text())
    rec = [r for r in doc["records"] if r["pattern"] == "banded"
           and r["placement"] == placement and r["p"] == p][0]
    (_, want), (n, got) = (_comm_scaling_cell(pkg, p, placement)
                           for pkg in PACKAGES)
    assert_same_report(got, want)
    from repro_torch.core import analysis as an
    summ = an.comm_summary(got.bytes_received)
    cp = an.critical_path_summary(got.crit.work_s, got.crit.length_s, p,
                                  got.makespan)
    assert n == rec["n"] and got.steals == rec["steals"]
    assert summ["avg_bytes"] / 1e6 == rec["avg_MB"]
    assert summ["max_bytes"] / 1e6 == rec["max_MB"]
    assert summ["imbalance"] == rec["imbalance"]
    assert float(np.mean(got.bytes_pushed)) / 1e6 == rec["pushed_MB_avg"]
    assert float(np.mean(got.active_fraction)) == rec["active"]
    for k in ("makespan_s", "work_s", "critical_path_s",
              "parallel_efficiency"):
        assert cp[k] == pytest.approx(rec[k], rel=1e-12, abs=0.0), k


def _fault_session(pkg, faults_build=None):
    """``benchmarks/bench_fault.py::_build_banded`` at the artifact's sizes
    (n 512, band 24, leaf_n 64, bs 8, p 8, seed 0)."""
    a = values_for_mask(banded_mask(512, 24), seed=1, symmetric=True)
    b = values_for_mask(banded_mask(512, 24), seed=2, symmetric=True)
    sess = pkg.Session(leaf_n=64, bs=8, p=8, seed=0, engine="numpy")
    A, B = sess.from_dense(a), sess.from_dense(b)
    sess.simulate(faults=faults_build)
    return sess, A @ B


def test_fault_lineage_row_reproduces():
    doc = json.loads((ROOT / "BENCH_fault.json").read_text())
    row = [r for r in doc["rows"] if r["pattern"] == "banded"
           and r["policy"] == "lineage" and r["n_failures"] == 1][0]
    free = [r for r in doc["rows"] if r["pattern"] == "banded"
            and r["policy"] == "fault-free"][0]
    out = []
    for pkg in PACKAGES:
        rec = pkg.runtime.recovery
        sess0, C0 = _fault_session(pkg)
        rep0 = sess0.simulate(fresh_stats=True)
        sess, C = _fault_session(pkg)
        rep = sess.simulate(fresh_stats=True, faults=rec.FaultSchedule(
            events=[rec.kill(0.45 * rep0.makespan, 2)], recovery="lineage",
            replicas=2))
        assert np.array_equal(C.to_dense(), C0.to_dense())
        out.append((rep0, rep))
    (r0, r1), (p0, p1) = out
    assert_same_report(p0, r0)
    assert_same_report(p1, r1)
    assert p0.makespan == free["makespan"] and p0.n_tasks == free["n_tasks"]
    assert p1.makespan == row["makespan"]
    assert p1.makespan / p0.makespan == row["degradation"]
    for k in ("tasks_recomputed", "chunks_lost", "chunks_recovered",
              "bytes_rereplicated", "n_failures"):
        assert getattr(p1, k) == row[k], k


# -- the torch engine under the simulator ------------------------------------

def _truncated_run(pkg, engine):
    idx = np.arange(N)
    decay = 0.5 ** np.abs(np.subtract.outer(idx, idx))
    a = values_for_mask(banded_mask(N, 9), seed=4) * decay
    sess = pkg.Session(engine=engine, leaf_n=LEAF_N, bs=BS, p=4, seed=1,
                       placement="random")
    A, B = sess.from_dense(a), sess.from_dense(a.T)
    sess.simulate()
    C = A.multiply(B, tau=1e-2)
    D = C @ A                       # an operand the engine produced
    rep = sess.simulate(fresh_stats=True)   # flushes the deferred waves
    return sess, rep, D


@pytest.mark.pallas
def test_torch_engine_report_matches_pallas_reference():
    """Float32 leaves on both sides (the reference's Pallas kernels in
    interpret mode, the port's plain versions): the same truncated
    schedule, bytes and flops."""
    _, want, _ = _truncated_run(repro, "pallas")
    _, got, _ = _truncated_run(repro_torch, TorchEngine(device="cpu"))
    assert_same_report(got, want)


def test_torch_engine_flush_gives_numpy_engine_flops():
    """``Scheduler.run`` flushes the deferred waves before it reads the
    tasks: per-task flops and the pruning decisions (norms read back from
    the waves) equal the numpy engine's.  Bytes differ by design: the
    torch engine's products are float32 leaves, half the numpy engine's."""
    ns, nrep, nd = _truncated_run(repro_torch, "numpy")
    ts, trep, td = _truncated_run(repro_torch, TorchEngine(device="cpu"))
    assert ts.engine_stats()["waves"] > 0
    assert [n.flops for n in ts.graph.nodes] == \
        [n.flops for n in ns.graph.nodes]
    assert [n.kind for n in ts.graph.nodes] == \
        [n.kind for n in ns.graph.nodes]
    assert trep.n_tasks == nrep.n_tasks
    assert trep.total_flops == nrep.total_flops
    np.testing.assert_allclose(td.to_dense(), nd.to_dense(), atol=1e-4)


def test_free_releases_store_bytes_and_calls_the_engine_hook_first(
        monkeypatch):
    """``Session.free`` under the torch engine: the engine hook runs
    before the scheduler's early return (nothing simulated yet), and
    after a simulation the chunk store's owned bytes drop by what free
    reports.  TorchEngine copies each wave back and holds no device
    buffer once flushed."""
    seen = []
    monkeypatch.setattr(TorchEngine, "free_chunks",
                        lambda self, g, nids: seen.append(set(nids)))
    sess = repro_torch.Session(engine=TorchEngine(device="cpu"),
                               leaf_n=LEAF_N, bs=BS, p=4)
    A, B = sess.from_dense(_banded(1)), sess.from_dense(_banded(2))
    C = A @ B
    C.to_dense()
    assert sess.free(C) == 0 and seen and C.node in seen[-1]
    assert sess.graph._engine._pending == []
    D = A @ B
    sess.simulate()
    owned = sum(s.owned_bytes for s in sess.scheduler.store.stats)
    freed = sess.free(D)
    assert freed > 0 and D.node in seen[-1]
    assert sum(s.owned_bytes for s in sess.scheduler.store.stats) == \
        owned - freed


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("pattern", ["banded", "s2"])
def test_an_eager_loop_that_frees_simulates_as_the_reference(pattern, dedup):
    """Products freed before any simulation, between two and after one
    (the first twice), with a worker killed in the last: each report
    equals the reference's, whose ``free`` keeps every host value.  The
    port lets go of the freed values, and the simulator still places and
    charges their chunks."""
    reps = []
    for pkg in PACKAGES:
        rec = __import__(f"{pkg.__name__}.runtime.recovery",
                         fromlist=["x"])
        sess, op = _build(pkg, pattern, p=4, seed=3, dedup=dedup)
        first = op()
        sess.free(first)
        out = [sess.simulate(fresh_stats=True)]
        c, d = op(), op()
        sess.free(c)
        out.append(sess.simulate(fresh_stats=True))
        sess.free(d)
        sess.free(first)            # now simulated: releases its chunks
        sess.free(op())
        out.append(sess.simulate(fresh_stats=True, faults=rec.FaultSchedule(
            events=[rec.kill(0.5 * out[-1].makespan, 2)],
            recovery="lineage")))
        reps.append(out)
    want, got = reps
    for g, w in zip(got, want):
        assert_same_report(g, w)
    assert got[-1].tasks_recomputed > 0


class TestExport:
    """``repro_torch.obs.export`` (the Perfetto export) against the
    reference's ``repro.obs.export``."""

    @staticmethod
    def _assert_monotone(doc):
        ts = [e["ts"] for e in doc["traceEvents"] if e["ph"] != "M"]
        assert ts == sorted(ts) and all(t >= 0 for t in ts)

    @pytest.mark.parametrize("pattern", ["banded", "s2"])
    def test_sim_trace_equals_reference(self, pattern, tmp_path):
        """The same graph and seed: the same Chrome trace, event by event,
        and the same file on disk."""
        docs, paths = [], []
        for pkg in PACKAGES:
            export = __import__(f"{pkg.__name__}.obs.export",
                                fromlist=["x"])
            _, rep = _measured(pkg, pattern, 4, "random")
            docs.append(export.chrome_trace(
                export.sim_trace_events(rep.trace)))
            paths.append(export.write_chrome_trace(
                tmp_path / f"{pkg.__name__}.trace.json",
                export.sim_trace_events(rep.trace)))
        want, got = docs
        assert got == want
        self._assert_monotone(got)
        assert paths[0].read_text() == paths[1].read_text()
        slices = [e for e in got["traceEvents"] if e["ph"] == "X"]
        assert len(slices) == len(rep.trace.events) > 0

    def test_span_events_of_a_traced_torch_session(self):
        """Spans and simulator events of one traced torch-engine session
        on two pid tracks, monotone, with the engine's wave spans."""
        from repro_torch.obs import chrome_trace, sim_trace_events, \
            span_events
        sess = repro_torch.Session(engine=TorchEngine(device="cpu"),
                                   trace=True, leaf_n=LEAF_N, bs=BS)
        A = sess.from_dense(_banded(1))
        (A @ A).to_dense()
        sess.simulate(p=2)
        doc = chrome_trace(span_events(sess.tracer))
        self._assert_monotone(doc)
        slices = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
        assert {"qt.multiply", "engine.wave", "kernel.dispatch",
                "session.simulate"} <= slices
        # each slice carries its span's id, parent and step
        ids = {sp.id: sp for sp in sess.tracer.spans}
        for e in doc["traceEvents"]:
            if e["ph"] == "X":
                sp = ids[e["args"]["span_id"]]
                assert (e["name"], e["args"]["parent_id"],
                        e["args"]["step"]) == (sp.name, sp.parent, sp.step)
        # the running counters, one sample each
        counters = {e["name"]: e["args"]["value"]
                    for e in doc["traceEvents"] if e["ph"] == "C"}
        assert counters == sess.tracer.counters
        assert counters["engine.pairs"] == \
            sess.engine_stats()["batched_pairs"]
        both = chrome_trace(span_events(sess.tracer),
                            sim_trace_events(sess._last_report.trace))
        self._assert_monotone(both)
        assert len({e["pid"] for e in both["traceEvents"]}) == 2

    def test_text_report_equals_reference(self):
        from repro.obs import text_report as ref_text_report
        from repro_torch.obs import text_report
        reps = [_measured(pkg, "banded", 4, "parent-worker")[1]
                for pkg in PACKAGES]
        want = ref_text_report(reps[0].to_metrics(), title="sim")
        assert text_report(reps[1].to_metrics(), title="sim") == want
        # a plain to_dict() document renders the same
        assert text_report(reps[1].to_metrics().to_dict(),
                           title="sim") == want

    def test_mesh_stats_events_from_log(self):
        """The hand-built ``stats`` dict of ``tests/test_obs.py``: the
        exporter needs no mesh engine and no device."""
        from repro_torch.obs import chrome_trace, mesh_stats_events
        st = {"n_dev": 2,
              "wave_log": [{"kernel": "k", "bs": 8, "tasks": 3,
                            "pairs": 5, "padded_pairs": 6, "c_blocks": 4,
                            "wall_s": 0.25}] * 2,
              "comm_log": [
                  {"fetched_bytes_by_dev": [256, 0],
                   "pushed_bytes_by_dev": [0, 512],
                   "collective_bytes_by_dev": [256, 0]},
                  {"fetched_bytes_by_dev": [0, 128],
                   "pushed_bytes_by_dev": [64, 0],
                   "collective_bytes_by_dev": [0, 128]},
              ]}
        doc = chrome_trace(mesh_stats_events(st))
        self._assert_monotone(doc)
        finals = {}
        for e in doc["traceEvents"]:
            if e["ph"] == "C" and e["name"].startswith("fetched_bytes"):
                finals[e["tid"]] = e["args"]["bytes"]
        assert finals == {0: 256, 1: 128}
        slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert len(slices) == 4     # 2 waves x 2 devices
        assert {e["dur"] for e in slices} == {0.25 * 1e6}
        from repro.obs import mesh_stats_events as ref_events
        assert mesh_stats_events(st) == ref_events(st)
