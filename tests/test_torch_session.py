"""The port's Session facade against the reference's, end to end.

The same numpy inputs go into ``repro.Session(engine="pallas")`` (Pallas
kernel bodies in interpret mode, n <= 128) and into
``repro_torch.Session(engine=TorchEngine(device="cpu"))`` (the kernels'
plain PyTorch versions).  State crosses as plain numpy: both packages take
numpy arrays, and their leaves are numpy blocks, compared block by block
through :func:`leaves_of`.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core.patterns import (banded_mask, divide_space_order,  # noqa: E402
                                 overlap_mask, particle_cloud, random_mask,
                                 values_for_mask)
from repro_torch.core.engine import (NumpyEngine, TorchEngine,  # noqa: E402
                                     make_engine)
from test_torch_engine import leaves  # noqa: E402

N, LEAF_N, BS = 64, 16, 4
ATOL = 1e-3


def leaves_of(matrix) -> dict:
    """Every stored leaf block of a matrix, keyed by ``(path, key)``.

    ``path`` is the quadrant path from the root (0..3 row-major), ``key``
    the block's (row, col) inside its leaf.  Works on both packages'
    matrices (their leaves are host numpy), which is how state is compared
    across them.
    """
    return leaves(matrix.session.graph, matrix.node)


def _sessions(**kw):
    return (repro.Session(engine="pallas", leaf_n=LEAF_N, bs=BS, **kw),
            repro_torch.Session(engine=TorchEngine(device="cpu"),
                                leaf_n=LEAF_N, bs=BS, **kw))


def _s2(n=N):
    coords = particle_cloud(4, 3, seed=7)
    m = overlap_mask(coords, 4.0, order=divide_space_order(coords))
    return values_for_mask(m, seed=1, symmetric=True)


INPUTS = {
    "banded": lambda s: values_for_mask(banded_mask(N, 5), seed=s),
    "random": lambda s: values_for_mask(random_mask(N, 0.1, seed=s), seed=s),
    "s2": lambda s: values_for_mask(_s2() != 0, seed=s),
}


def _assert_same(ref_sess, ref_m, port_sess, port_m, want=None):
    assert port_sess.task_counts() == ref_sess.task_counts()
    assert port_sess.tasks_per_level() == ref_sess.tasks_per_level()
    assert port_sess.n_multiply_tasks == ref_sess.n_multiply_tasks
    assert port_sess.n_add_tasks == ref_sess.n_add_tasks
    assert port_sess.flops == ref_sess.flops
    kinds = [n.kind for n in port_sess.graph.nodes]
    assert kinds == [n.kind for n in ref_sess.graph.nodes]
    rl, pl = leaves_of(ref_m), leaves_of(port_m)
    assert pl.keys() == rl.keys()
    for k in rl:
        np.testing.assert_allclose(pl[k], rl[k], atol=ATOL)
    ws = [[{k: v for k, v in w.items() if k != "wall_s"}
           for w in s.engine_stats()["wave_log"]]
          for s in (ref_sess, port_sess)]
    assert ws[1] == ws[0]
    if want is not None:
        np.testing.assert_allclose(port_m.to_dense(), want, atol=ATOL)


@pytest.mark.pallas
class TestAgainstPallasSession:
    @pytest.mark.parametrize("pattern", sorted(INPUTS))
    def test_matmul(self, pattern):
        a, b = INPUTS[pattern](1), INPUTS[pattern](2)
        (rs, ps) = _sessions()
        rc = rs.from_dense(a) @ rs.from_dense(b)
        pc = ps.from_dense(a) @ ps.from_dense(b)
        _assert_same(rs, rc, ps, pc, a @ b)

    def test_transposed_matmul(self):
        a, b = INPUTS["random"](3), INPUTS["banded"](4)
        rs, ps = _sessions()
        rc = rs.from_dense(a).T @ rs.from_dense(b)
        pc = ps.from_dense(a).T @ ps.from_dense(b)
        _assert_same(rs, rc, ps, pc, a.T @ b)

    def test_sym_square(self):
        s = _s2()
        rs, ps = _sessions()
        rc = rs.from_dense(s, upper=True).sym_square()
        pc = ps.from_dense(s, upper=True).sym_square()
        assert pc.upper
        _assert_same(rs, rc, ps, pc, s @ s)

    def test_add_and_scale(self):
        a, b = INPUTS["banded"](5), INPUTS["random"](6)
        rs, ps = _sessions()
        rc = 2.5 * (rs.from_dense(a) @ rs.from_dense(b)) + rs.from_dense(b)
        pc = 2.5 * (ps.from_dense(a) @ ps.from_dense(b)) + ps.from_dense(b)
        _assert_same(rs, rc, ps, pc, 2.5 * (a @ b) + b)

    def test_lazy_plan_replay_registers_nothing(self):
        x0, x1 = INPUTS["banded"](7), INPUTS["banded"](8)   # one structure
        rs, ps = _sessions(lazy=True)
        outs = []
        for sess in (rs, ps):
            X = sess.from_dense(x0, name="X")
            plan = sess.compile(X @ X + X)
            np.testing.assert_allclose(plan.run().to_dense(), x0 @ x0 + x0,
                                       atol=ATOL)
            n_tasks = len(sess.graph.nodes)
            Z = plan.run(X=x1)
            assert len(sess.graph.nodes) == n_tasks     # zero new tasks
            outs.append((sess, Z))
        _assert_same(outs[0][0], outs[0][1], outs[1][0], outs[1][1],
                     x1 @ x1 + x1)

    def test_truncated_multiply_frozen_pairs(self):
        idx = np.arange(N)
        rng = np.random.default_rng(8)
        decay = np.exp(-0.4 * np.abs(idx[:, None] - idx[None, :]))
        a, a2 = (decay * rng.standard_normal((N, N)) for _ in range(2))
        rs, ps = _sessions(lazy=True)
        res = []
        for sess in (rs, ps):
            X = sess.from_dense(a, name="X")
            plan = sess.compile(X.multiply(X, tau=1e-2))
            C = plan.run()
            err = np.linalg.norm(C.to_dense() - a @ a)
            assert 0.0 < err <= C.error_bound
            n_tasks = len(sess.graph.nodes)
            C2 = plan.run(X=a2)       # replays the frozen pair lists
            assert len(sess.graph.nodes) == n_tasks
            res.append((sess, C2, C.error_bound))
        assert res[1][2] == res[0][2]
        _assert_same(res[0][0], res[0][1], res[1][0], res[1][1])


def test_leaves_match_numpy_engine_n256():
    rng = np.random.default_rng(9)
    a = values_for_mask(banded_mask(256, 20), seed=10)
    b = np.where(rng.random((256, 256)) < 0.05,
                 rng.standard_normal((256, 256)), 0.0)
    out = []
    for eng in (NumpyEngine(), TorchEngine(device="cpu")):
        sess = repro_torch.Session(engine=eng, leaf_n=64, bs=8)
        c = sess.from_dense(a) @ sess.from_dense(b).T
        out.append((sess.task_counts(), leaves_of(c)))
    assert out[1][0] == out[0][0]
    assert out[1][1].keys() == out[0][1].keys()
    for k, blk in out[0][1].items():
        np.testing.assert_allclose(out[1][1][k], blk, atol=ATOL)


class TestFacadeContract:
    @pytest.mark.parametrize("spec", ["pallas", "nccl", "cuda", 42, None])
    def test_reference_engine_names_rejected(self, spec):
        with pytest.raises(ValueError, match="unknown leaf engine"):
            repro_torch.Session(engine=spec)

    def test_engine_mesh_is_a_mesh_engine(self, monkeypatch):
        """``Session(engine="mesh")`` builds a MeshEngine at its first leaf
        task (on the card: without CUDA it raises, no fallback)."""
        from repro_torch.launch.mesh_exec import MeshEngine
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        sess = repro_torch.Session(engine="mesh", leaf_n=16, bs=4)
        assert type(sess.graph.engine) is MeshEngine
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        sess = repro_torch.Session(engine="mesh", leaf_n=16, bs=4)
        a = sess.from_dense(np.eye(32))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            a @ a

    def test_engine_torch_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        sess = repro_torch.Session(engine="torch", leaf_n=16, bs=4)
        a = sess.from_dense(np.eye(32))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            a @ a

    def test_default_engine_is_the_card(self, monkeypatch):
        """``Session()`` runs on the card; without CUDA it raises and
        names the CPU opt-in instead of falling back to the host."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        sess = repro_torch.Session(leaf_n=16, bs=4)
        assert "engine='torch'" in repr(sess)
        a = sess.from_dense(np.eye(32))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            a @ a
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_engine(None)

    def test_simulator_not_ported(self):
        """``simulate`` and ``reset_stats`` run now, and so do the training
        loop's compression, fault injection, elastic planning and
        ``reshard_tree`` (a rank's blocks of a tree on a new mesh)."""
        sess = repro_torch.Session(engine="numpy", leaf_n=16, bs=4)
        sess.from_dense(np.eye(32))
        assert sess.simulate(p=4).n_workers == 4
        sess.reset_stats()
        assert all(st.bytes_received == 0 and st.messages_received == 0
                   for st in sess.scheduler.store.stats)
        import repro_torch.runtime as rt
        assert callable(rt.quantize_int8) and callable(rt.TrainingRunner)
        assert rt.elastic_remesh_plan((4, 2), ("data", "model"),
                                      1).new_shape == (3, 2)
        from repro_torch.configs import get_smoke_config
        cfg = get_smoke_config("llama3_2_3b")
        full = {"embed": torch.arange(cfg.vocab * cfg.d_model).reshape(
            cfg.vocab, cfg.d_model)}
        got = rt.reshard_tree(full, cfg, {"data": 1, "model": 2},
                              coords={"data": 0, "model": 1})
        assert torch.equal(got["embed"], full["embed"][cfg.vocab // 2:])

    def test_metrics_source(self):
        sess = repro_torch.Session(engine=TorchEngine(device="cpu"),
                                   leaf_n=16, bs=4)
        a = sess.from_dense(np.eye(32))
        (a @ a).to_dense()
        ms, graph = sess.metrics()
        assert ms.source == "engine:torch" and graph.source == "graph"


def test_port_imports_neither_jax_nor_repro():
    """A whole CPU ``A @ B`` session, simulated, the solvers, a plan
    server, the Perfetto export, the report, the roofline, the mesh
    (a world of one: ``MeshEngine``, the halo, demand and SpSUMMA
    multiplies, ``bsmm``) and the training path (optimizer, data,
    checkpoints, fault runner, compression, train step, driver) load no
    jax and no ``repro`` module; importing the runtime, the analysis, the
    server, the launch modules, the mesh's and the training path's modules
    starts no CUDA context and no process group."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        import repro_torch.runtime as rt
        from repro_torch.core import analysis
        from repro_torch.runtime import FaultSchedule, Scheduler, kill
        import repro_torch.serve
        from repro_torch.launch import report, roofline
        from repro_torch.obs import export
        from repro_torch.core import (blocksparse, bsmm, distributed,
                                      morton, spsumma)
        from repro_torch.launch import mesh, mesh_exec
        from repro_torch import checkpoint, data, optim
        from repro_torch.runtime import compression, fault
        from repro_torch.launch import dryrun, sharding, train
        from repro_torch.kernels import block_attention_bwd
        assert not torch.cuda.is_initialized()
        assert not torch.distributed.is_initialized()
        import repro_torch
        from repro_torch.core.engine import TorchEngine
        from repro_torch.solvers import (TauPolicy, inverse_factor,
                                         multiply_chain, scf_density)
        sess = repro_torch.Session(engine=TorchEngine(device="cpu"),
                                   leaf_n=16, bs=4, p=4)
        a = np.triu(np.tril(np.ones((64, 64)), 3), -3)
        c = (sess.from_dense(a) @ sess.from_dense(a).T).to_dense()
        assert np.allclose(c, a @ a.T, atol=1e-4)
        rep = sess.simulate(faults=FaultSchedule(events=[kill(0.0, 3)]))
        assert analysis.comm_summary(rep.bytes_received)["n_workers"] == 4
        s = np.eye(64) + 0.1 * (np.eye(64, k=1) + np.eye(64, k=-1))
        z, frep = inverse_factor(sess.from_dense(s, upper=True),
                                 method="localized", tol=1e-4)
        assert frep.converged
        srv = repro_torch.serve.PlanServer(device="cpu", leaf_n=16, bs=4)
        srv.register("A", a)
        t = srv.submit(repro_torch.serve.Request.multiply("A", "A"))
        srv.drain()
        assert np.allclose(t.result, a @ a, atol=1e-4)
        doc = export.chrome_trace(export.sim_trace_events(rep.trace))
        assert doc["traceEvents"]
        assert "| 1 |" in report.serve_table({"rows": [dict(
            max_inflight=1, requests_per_s=1.0, p50_ms=1.0, p95_ms=1.0,
            p99_ms=1.0, hit_rate=1.0, merged_waves=0, solo_waves=1,
            requests=1)]})
        assert roofline.Roofline(1.0, 1.0, 1.0, 1,
                                 roofline.Hardware()).t_bound > 0
        msess = repro_torch.Session(
            engine=mesh_exec.MeshEngine(device="cpu"), leaf_n=16, bs=4)
        c = (msess.from_dense(a) @ msess.from_dense(a)).to_dense()
        assert np.allclose(c, a @ a, atol=1e-4)
        st = msess.engine_stats()
        assert st["n_dev"] == 1 and st["collective_bytes"] == [0]
        ma = a.reshape(16, 4, 16, 4).any(axis=(1, 3))
        plan = distributed.plan_demand(ma, ma, 4, 1)
        shard = distributed.distribute_morton(a, 4, plan)
        t = [torch.from_numpy(x) for x in shard + shard]
        t = [x[0] for x in t]
        cb, cr, cc, _ = distributed.demand_spmm(mesh.make_spmm_mesh(),
                                                "dev", plan, *t)
        got = distributed.gather_dense(cb[None].numpy(), cr[None].numpy(),
                                       cc[None].numpy(), 16, 4)
        assert np.allclose(got, a @ a, atol=1e-4)
        sp = spsumma.plan_summa(ma, ma, 4, 1)
        t = [torch.from_numpy(x[0]) for x in
             spsumma.distribute_panels(a, 4, sp) * 2]
        cb, cr, cc, _ = spsumma.summa_spmm(mesh.make_summa_mesh(),
                                           ("pr", "pc"), sp, *t)
        got = distributed.gather_dense(cb[None].numpy(), cr[None].numpy(),
                                       cc[None].numpy(), 16, 4)
        assert np.allclose(got, a @ a, atol=1e-4)
        import tempfile
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import model as M
        cfg = get_smoke_config("h2o_danube3_4b")
        params = M.init_params(cfg, device="cpu")
        opt = optim.adamw_init(params)
        batch = data.SyntheticLM(cfg.vocab, 64, 2).batch_at(0)
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        step = sharding.TrainStep(cfg).step_fn()
        params, opt, metrics = step(params, opt, batch)
        assert int(opt.step) == 1 and bool(torch.isfinite(metrics["loss"]))
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save_checkpoint(d, 1, (1, (params, opt)))
            (n, _), _ = checkpoint.load_checkpoint(d, 1, (0, (params, opt)))
            assert int(n) == 1
        q, s = compression.quantize_int8(params["embed"])
        assert q.dtype == torch.int8 and fault.FaultInjector({}).schedule == []
        assert not torch.cuda.is_initialized()
        assert not torch.distributed.is_initialized()
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "jaxlib"))
               or m == "repro" or m.startswith("repro.")]
        assert not bad, bad
        print("clean")
    """)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
