"""The port's TorchEngine against the reference's PallasEngine.

The same numpy inputs build the same task programs on a ``repro`` graph
(``PallasEngine``, kernel bodies in interpret mode) and on a
``repro_torch`` graph (``TorchEngine(device="cpu")``, the kernels' plain
PyTorch versions).  The graphs must be identical node for node, every
wave-log field except ``wall_s`` must be equal, and the leaves must agree
within the float32 contract (atol 1e-3).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.bsmm as r_bsmm  # noqa: E402
import repro.core.engine as r_engine  # noqa: E402
import repro.core.multiply as r_multiply  # noqa: E402
import repro.core.quadtree as r_quadtree  # noqa: E402
import repro.core.tasks as r_tasks  # noqa: E402
import repro.core.triangular as r_triangular  # noqa: E402
import repro.kernels.tri as r_tri  # noqa: E402
import repro_torch.core.bsmm as t_bsmm  # noqa: E402
import repro_torch.core.engine as t_engine  # noqa: E402
import repro_torch.core.multiply as t_multiply  # noqa: E402
import repro_torch.core.quadtree as t_quadtree  # noqa: E402
import repro_torch.core.tasks as t_tasks  # noqa: E402
import repro_torch.core.triangular as t_triangular  # noqa: E402
import repro_torch.kernels.tri as t_tri  # noqa: E402
from repro.core.patterns import (banded_mask, divide_space_order,  # noqa: E402
                                 overlap_mask, particle_cloud, random_mask,
                                 values_for_mask)

ATOL = 1e-3


def _ns(multiply, quadtree, tasks, triangular):
    return types.SimpleNamespace(
        **{k: getattr(multiply, k) for k in (
            "qt_multiply", "qt_add", "qt_scale", "qt_transpose",
            "qt_sym_square", "qt_syrk", "qt_sym_multiply", "qt_replay",
            "count_tasks_per_level", "total_multiply_tasks", "total_flops")},
        qt_from_dense=quadtree.qt_from_dense, qt_to_dense=quadtree.qt_to_dense,
        QTParams=quadtree.QTParams, CTGraph=tasks.CTGraph,
        qt_inv_chol=triangular.qt_inv_chol,
        qt_tri_solve=triangular.qt_tri_solve)


REF = _ns(r_multiply, r_quadtree, r_tasks, r_triangular)
PORT = _ns(t_multiply, t_quadtree, t_tasks, t_triangular)


def _s2_mask(n=64):
    coords = particle_cloud(4, 3, seed=7)          # 64 basis functions
    return overlap_mask(coords, 4.0, order=divide_space_order(coords))


PATTERNS = {
    "random": lambda n: random_mask(n, 0.12, seed=3),
    "banded": lambda n: banded_mask(n, 6),
    "s2": lambda n: _s2_mask(n),
}


def leaves(g, nid) -> dict:
    """Every leaf block of a quadtree: ``{(path, key): block}``."""
    g.flush()
    out = {}

    def walk(nid, path):
        ch = g.value_of(nid)
        if ch is None:
            return
        if ch.is_leaf:
            for key, blk in ch.leaf.blocks.items():
                out[(path, key)] = np.asarray(blk, np.float64)
            return
        for q, child in enumerate(ch.children):
            walk(child, path + (q,))

    walk(nid, ())
    return out


def structure(g) -> list:
    """Node-for-node task graph signature (no values)."""
    return [(n.kind, n.parent, [(d.nid, d.fetch) for d in n.deps],
             n.alias_of, n.level, n.flops, n.value is None) for n in g.nodes]


def _waves(stats) -> list:
    return [{k: v for k, v in w.items() if k != "wall_s"}
            for w in stats["wave_log"]]


def _run_both(build, *, n=64, leaf_n=16, bs=4, kernel="pairs", port=None):
    """``build(ns, g, params) -> root`` on the reference and the port."""
    outs = {}
    for side, ns, eng in (
            ("ref", REF, r_engine.PallasEngine(kernel=kernel,
                                               interpret=True)),
            ("port", PORT, port or t_engine.TorchEngine(kernel=kernel,
                                                        device="cpu"))):
        params = ns.QTParams(n, leaf_n, bs)
        g = ns.CTGraph(engine=eng)
        root = build(ns, g, params)
        outs[side] = (ns, g, root, params)
    return outs


def _assert_same(outs, dense_want=None):
    (rns, rg, rroot, rp), (tns, tg, troot, tp) = outs["ref"], outs["port"]
    assert structure(tg) == structure(rg)
    assert tns.count_tasks_per_level(tg) == rns.count_tasks_per_level(rg)
    assert tns.total_multiply_tasks(tg) == rns.total_multiply_tasks(rg)
    assert tns.total_flops(tg) == rns.total_flops(rg)
    rl, tl = leaves(rg, rroot), leaves(tg, troot)
    assert rl.keys() == tl.keys()
    for k in rl:
        np.testing.assert_allclose(tl[k], rl[k], atol=ATOL)
    assert _waves(tg.engine.stats()) == _waves(rg.engine.stats())
    st = tg.engine.stats()
    assert st["backend"] == "torch" and st["waves"] >= 1
    if dense_want is not None:
        np.testing.assert_allclose(tns.qt_to_dense(tg, troot, tp),
                                   dense_want, atol=ATOL)


def _vals(pattern, seed, n=64):
    return values_for_mask(PATTERNS[pattern](n), seed=seed)


@pytest.mark.pallas
class TestAgainstPallasEngine:
    @pytest.mark.parametrize("pattern", sorted(PATTERNS))
    def test_multiply(self, pattern):
        a, b = _vals(pattern, 1), _vals(pattern, 2)

        def build(ns, g, p):
            return ns.qt_multiply(g, p, ns.qt_from_dense(g, a, p),
                                  ns.qt_from_dense(g, b, p))
        _assert_same(_run_both(build), a @ b)

    @pytest.mark.parametrize("ta,tb", [(True, False), (False, True)])
    def test_transposed_multiply(self, ta, tb):
        a, b = _vals("random", 3), _vals("banded", 4)

        def build(ns, g, p):
            return ns.qt_multiply(g, p, ns.qt_from_dense(g, a, p),
                                  ns.qt_from_dense(g, b, p), ta=ta, tb=tb)
        _assert_same(_run_both(build),
                     (a.T if ta else a) @ (b.T if tb else b))

    def test_gemm_kernel(self):
        a, b = _vals("s2", 5), _vals("banded", 6)

        def build(ns, g, p):
            return ns.qt_multiply(g, p, ns.qt_from_dense(g, a, p),
                                  ns.qt_from_dense(g, b, p))
        outs = _run_both(build, kernel="gemm")
        _assert_same(outs, a @ b)
        w = outs["port"][1].engine.stats()["wave_log"][0]
        assert w["kernel"] == "gemm"
        assert w["padded_pairs"] == w["pairs"] + (-w["pairs"]) % 8

    def test_symmetric_kinds_and_host_fills(self):
        s = _vals("s2", 7)
        s = (s + s.T) / 2
        b = _vals("random", 8)

        def build(ns, g, p):
            su = ns.qt_from_dense(g, s, p, upper=True)
            rb = ns.qt_from_dense(g, b, p)
            x = ns.qt_sym_multiply(g, p, ns.qt_sym_square(g, p, su), rb)
            y = ns.qt_sym_multiply(g, p, ns.qt_syrk(g, p, rb, trans=True),
                                   rb, side="right")
            return ns.qt_add(g, p, ns.qt_scale(g, p, ns.qt_transpose(
                g, p, x), -0.5), ns.qt_add(g, p, y, rb))
        want = -0.5 * (s @ s @ b).T + (b @ (b.T @ b) + b)
        _assert_same(_run_both(build), want)

    def test_chained_waves_and_replay(self):
        """Results feed later waves; a replay refills them identically."""
        a = _vals("banded", 9)

        def build(ns, g, p):
            ra = ns.qt_from_dense(g, a, p)
            c = ns.qt_multiply(g, p, ra, ra)
            d = ns.qt_multiply(g, p, c, ra, tb=True)
            ns.qt_to_dense(g, d, p)             # flush
            ns.qt_replay(g, range(len(g.nodes)))
            return d
        _assert_same(_run_both(build), a @ a @ a.T)

    def test_truncated_multiply(self):
        rng = np.random.default_rng(0)
        idx = np.arange(64)
        a = np.exp(-0.5 * np.abs(idx[:, None] - idx[None, :])) \
            * rng.standard_normal((64, 64))

        def build(ns, g, p):
            ra = ns.qt_from_dense(g, a, p)
            return ns.qt_multiply(g, p, ra, ra, tau=1e-3)
        _assert_same(_run_both(build))

    def test_solve_waves(self):
        idx = np.arange(64)
        s = np.exp(-np.abs(idx[:, None] - idx[None, :]))   # SPD (Kac)
        r = np.linalg.cholesky(s).T
        b = _vals("random", 10)

        def build(ns, g, p):
            z = ns.qt_inv_chol(g, p, ns.qt_from_dense(g, s, p, upper=True))
            x = ns.qt_tri_solve(g, p, ns.qt_from_dense(g, r, p),
                                ns.qt_from_dense(g, b, p))
            return ns.qt_add(g, p, z, x)
        want = np.linalg.inv(r) + np.linalg.solve(r, b)
        _assert_same(_run_both(build), want)

    def test_validate_structure(self):
        a, b = _vals("random", 11), _vals("s2", 12)

        def build(ns, g, p):
            ra, rb = ns.qt_from_dense(g, a, p), ns.qt_from_dense(g, b, p)
            c = ns.qt_multiply(g, p, ra, rb, tb=True)
            return ns.qt_multiply(g, p, c, rb, tau=1e-2)
        port = t_engine.TorchEngine(device="cpu", validate_structure=True)
        _assert_same(_run_both(build, port=port))


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_leaves_match_numpy_engine_n256(pattern):
    a = _vals(pattern, 13, n=256) if pattern != "s2" else \
        np.kron(np.eye(4), _vals("s2", 13))
    b = _vals("banded", 14, n=256)
    out = {}
    for name, eng in (("numpy", t_engine.NumpyEngine()),
                      ("torch", t_engine.TorchEngine(device="cpu"))):
        p = PORT.QTParams(256, 32, 8)
        g = PORT.CTGraph(engine=eng)
        root = PORT.qt_multiply(g, p, PORT.qt_from_dense(g, a, p),
                                PORT.qt_from_dense(g, b, p))
        out[name] = (leaves(g, root), structure(g))
    assert out["torch"][1] == out["numpy"][1]
    assert out["torch"][0].keys() == out["numpy"][0].keys()
    for k, blk in out["numpy"][0].items():
        np.testing.assert_allclose(out["torch"][0][k], blk, atol=ATOL)


@pytest.mark.parametrize("tau", [0.0, 0.5])
def test_compute_c_structure_matches_reference(tau):
    rng = np.random.default_rng(1)
    na = rng.random((12, 12)) * (rng.random((12, 12)) < 0.3)
    nb = rng.random((12, 12)) * (rng.random((12, 12)) < 0.3)
    want = r_bsmm.compute_c_structure_norms(
        jnp.asarray(na, jnp.float32), jnp.asarray(nb, jnp.float32), tau,
        cap_c=144)
    got = t_bsmm.compute_c_structure_norms(
        torch.tensor(na, dtype=torch.float32),
        torch.tensor(nb, dtype=torch.float32), tau, cap_c=144)
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_tri_matches_reference():
    idx = np.arange(16)
    s = np.stack([np.exp(-(k + 1) * 0.3 * np.abs(idx[:, None] - idx[None]))
                  for k in range(3)]).astype(np.float32)
    b = np.random.default_rng(2).standard_normal((3, 16, 16)).astype(
        np.float32)
    z = t_tri.batched_inv_chol(torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(
        z, np.asarray(r_tri.batched_inv_chol(jnp.asarray(s))), atol=1e-4)
    np.testing.assert_allclose(
        t_tri.batched_tri_solve(torch.from_numpy(z), torch.from_numpy(b)),
        np.asarray(r_tri.batched_tri_solve(jnp.asarray(z), jnp.asarray(b))),
        atol=1e-3)


@pytest.mark.parametrize("kernel", ["pairs", "gemm"])
def test_kernels_get_contiguous_operands(monkeypatch, kernel):
    """Transposed operands are packed C-contiguous, as the kernels need."""
    from repro_torch.kernels import ops
    seen = []

    def spy(name):
        orig = getattr(ops, name)

        def fn(*args, **kw):
            seen.append(name)
            assert all(t.is_contiguous() for t in args)
            return orig(*args, **kw)
        return fn
    for name in ("bsmm_pairs", "batched_gemm"):
        monkeypatch.setattr(ops, name, spy(name))
    a, b = _vals("random", 15), _vals("banded", 16)
    p = PORT.QTParams(64, 16, 4)
    g = PORT.CTGraph(engine=t_engine.TorchEngine(kernel=kernel,
                                                 device="cpu"))
    root = PORT.qt_multiply(g, p, PORT.qt_from_dense(g, a, p),
                            PORT.qt_from_dense(g, b, p), ta=True, tb=True)
    np.testing.assert_allclose(PORT.qt_to_dense(g, root, p), a.T @ b.T,
                               atol=ATOL)
    assert seen == ["bsmm_pairs" if kernel == "pairs" else "batched_gemm"]


class TestEngineContract:
    def test_no_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_engine.TorchEngine()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_engine.make_engine("torch")

    @pytest.mark.parametrize("spec", ["pallas", "mesh", "cuda"])
    def test_reference_engine_names_rejected(self, spec):
        with pytest.raises(ValueError, match="unknown leaf engine"):
            t_engine.make_engine(spec)

    def test_bad_kernel_and_device(self):
        with pytest.raises(ValueError, match="kernel"):
            t_engine.TorchEngine(kernel="conv", device="cpu")
        with pytest.raises(ValueError, match="runs on"):
            t_engine.TorchEngine(device="meta")

    def test_rebind_raises(self):
        eng = t_engine.TorchEngine(device="cpu")
        p = PORT.QTParams(16, 16, 4)
        a = np.eye(16)
        g1, g2 = PORT.CTGraph(engine=eng), PORT.CTGraph(engine=eng)
        r1 = PORT.qt_from_dense(g1, a, p)
        PORT.qt_multiply(g1, p, r1, r1)
        r2 = PORT.qt_from_dense(g2, a, p)
        with pytest.raises(t_engine.EngineRebindError):
            PORT.qt_multiply(g2, p, r2, r2)

    def test_deadlock_error(self):
        eng = t_engine.TorchEngine(device="cpu")
        p = PORT.QTParams(16, 16, 4)
        g = PORT.CTGraph(engine=eng)
        r = PORT.qt_from_dense(g, np.eye(16), p)
        PORT.qt_multiply(g, p, r, r)
        eng._unfilled.add(id(g.value_of(r).leaf))   # an input never filled
        with pytest.raises(RuntimeError, match="deadlock"):
            g.flush()

    def test_simulator_not_ported(self):
        """The simulator is ported (``ClusterSim`` runs); the training
        loop's fault injection is not, and says where it is queued."""
        g = PORT.CTGraph(engine="numpy")
        p = PORT.QTParams(32, 16, 4)
        r = PORT.qt_from_dense(g, np.eye(32), p)
        PORT.qt_multiply(g, p, r, r)
        assert t_tasks.ClusterSim(4).run(g).n_tasks == len(g.nodes)
        import repro_torch.runtime as rt
        with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
            rt.FaultInjector
