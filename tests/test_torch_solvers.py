"""The port's electronic-structure solvers (``repro_torch.solvers``)
against the reference's (``repro.solvers``).

The same float64 arrays, made with numpy from a seed, go into
``repro.Session`` and ``repro_torch.Session``.  On the numpy engines the
two packages run the same float64 arithmetic, so the structural counts
(multiply tasks, iterations, splits, chain taus and flops, SCF replays and
successor-cache hits) must be equal and the numbers equal to 1e-10.  On
the port's torch engine (the kernels' plain versions on the CPU, float32
packing) the results are held to the reference's float32 tolerance.
"""
import json
import math
import pathlib
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro import solvers as ref_solvers  # noqa: E402
from repro_torch import solvers as port_solvers  # noqa: E402
from repro_torch.core.engine import TorchEngine  # noqa: E402
import test_solvers as ref_tests  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))
from bench_solvers import chain_factors, make_spd  # noqa: E402

N = ref_tests.N
LEAF_N, BS = 16, 4
TOL32 = dict(atol=2e-4, rtol=2e-4)      # the reference's float32 tolerance
PATTERNS = ("banded", "s2", "random")
METHODS = ("recursive", "localized", "global")
#: the reference's solver sweep (benchmarks/bench_solvers.py, n = 128)
BENCH = json.loads((ROOT / "BENCH_solvers.json").read_text())


def _spd_at(pattern, n):
    """tests/test_solvers.py's inputs at n = 64, the solver sweep's
    (``bench_solvers.make_spd``) at n = 128."""
    return ref_tests._spd(pattern) if n == N else make_spd(pattern, n)


def _factor(pkg, solvers, s, method, engine="numpy"):
    sess = pkg.Session(engine=engine, leaf_n=LEAF_N, bs=BS)
    kw = dict(tol=1e-4, tau=1e-7) if method != "recursive" else {}
    z, rep = solvers.inverse_factor(sess.from_dense(s, upper=True),
                                    method=method, **kw)
    return z.to_dense(), rep


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_inverse_factor_matches_reference(pattern, method, n):
    s = _spd_at(pattern, n)
    zr, rr = _factor(repro, ref_solvers, s, method)
    zp, rp = _factor(repro_torch, port_solvers, s, method)
    for k in ("method", "iterations", "multiply_tasks", "splits",
              "converged", "flops", "tau", "tol"):
        assert getattr(rp, k) == getattr(rr, k), k
    np.testing.assert_allclose(zp, zr, atol=1e-10, rtol=0)
    assert rp.residual == pytest.approx(rr.residual, rel=1e-6, abs=1e-12)
    measured = np.linalg.norm(zp.T @ s @ zp - np.eye(n))
    assert measured <= rp.residual + 1e-9
    if n == 128:    # the committed sweep, reproduced: localized against
        # global, 2066/2421 multiply tasks (banded), 6085/13103 (S2) and
        # 6106/13125 (random)
        row = [r for r in BENCH["factor_rows"] if r["pattern"] == pattern
               and r["method"] == method][0]
        for k in ("iterations", "multiply_tasks", "splits", "flops"):
            assert getattr(rp, k) == row[k], k


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_inverse_factor_torch_engine(pattern, method):
    """The port's torch engine on the CPU (float32 packing) against the
    reference's numpy engine, within the reference's float32 tolerance."""
    s = ref_tests._spd(pattern)
    zr, rr = _factor(repro, ref_solvers, s, method)
    zp, rp = _factor(repro_torch, port_solvers, s, method,
                     engine=TorchEngine(device="cpu"))
    np.testing.assert_allclose(zp, zr, **TOL32)
    np.testing.assert_allclose(zp.T @ s @ zp, np.eye(N), **TOL32)
    assert rp.converged and rp.splits == rr.splits
    if method != "recursive":
        assert rp.residual <= 2 * 1e-4


def _chain(pkg, solvers, mats, target, engine="numpy"):
    sess = pkg.Session(engine=engine, leaf_n=LEAF_N, bs=BS)
    ms = [sess.from_dense(m) for m in mats]
    policy = solvers.TauPolicy(target=target) if target else None
    p, rep = solvers.multiply_chain(ms, policy=policy)
    return p.to_dense(), rep


@pytest.mark.parametrize("target", [0.0, 1e-5, 1e-3, 1e-1])
def test_multiply_chain_matches_reference(target):
    mats = ref_tests._chain_factors()
    exact = mats[0]
    for a in mats[1:]:
        exact = exact @ a
    pr, rr = _chain(repro, ref_solvers, mats, target)
    pp, rp = _chain(repro_torch, port_solvers, mats, target)
    assert rp.taus == rr.taus and rp.steps == rr.steps == len(mats) - 1
    assert rp.step_bounds == rr.step_bounds
    assert rp.accumulated_bound == rr.accumulated_bound
    assert rp.flops == rr.flops and rp.pruned_flops == rr.pruned_flops
    np.testing.assert_allclose(pp, pr, atol=1e-10, rtol=0)
    err = np.linalg.norm(pp - exact)
    assert err <= rp.accumulated_bound + 1e-9
    if target:
        assert rp.accumulated_bound <= target
        assert rp.pruned_flops > 0
    else:
        assert rp.accumulated_bound == 0.0


def test_multiply_chain_reproduces_the_sweep():
    """``BENCH_solvers.json``'s chain rows (n = 128, four factors): taus,
    bounds and flops at every target, live through the port."""
    mats = chain_factors(128, k=4)
    exact = mats[0]
    for m in mats[1:]:
        exact = exact @ m
    for row in BENCH["chain_rows"]:
        sess = repro_torch.Session(engine="numpy", leaf_n=LEAF_N, bs=BS)
        ms = [sess.from_dense(m) for m in mats]
        policy = (port_solvers.TauPolicy(target=row["target"])
                  if row["target"] else None)
        p, rep = port_solvers.multiply_chain(ms, policy=policy)
        assert rep.taus == row["taus"]
        assert rep.accumulated_bound == row["accumulated_bound"]
        assert rep.flops == row["flops"]
        assert rep.pruned_flops == row["pruned_flops"]
        err = float(np.linalg.norm(p.to_dense() - exact))
        assert err == pytest.approx(row["measured_error"], rel=1e-6)


def test_multiply_chain_torch_engine():
    """Float32 packing adds engine arithmetic on top of truncation: the
    reference's slack for it is 1e-3 (tests/test_solvers.py)."""
    mats = ref_tests._chain_factors()
    exact = mats[0]
    for a in mats[1:]:
        exact = exact @ a
    _, rr = _chain(repro, ref_solvers, mats, 1e-2)
    pp, rp = _chain(repro_torch, port_solvers, mats, 1e-2,
                    engine=TorchEngine(device="cpu"))
    assert np.linalg.norm(pp - exact) <= rp.accumulated_bound + 1e-3
    assert rp.accumulated_bound <= 1e-2
    assert rp.taus[0] == rr.taus[0]
    assert rp.taus == pytest.approx(rr.taus, rel=1e-4)


def _scf(pkg, solvers, f, s, engine="numpy", **kw):
    sess = pkg.Session(engine=engine, leaf_n=LEAF_N, bs=BS, lazy=True)
    d, rep = solvers.scf_density(sess, f, s, N // 2, **kw)
    return d.to_dense(), rep


@pytest.mark.parametrize("filter_tol", [0.0, 1e-7])
def test_scf_density_matches_reference(filter_tol):
    """Zero replay tasks on a frozen structure; under ``filter_tol`` the
    structure drifts and the successor cache's hits and misses match."""
    if filter_tol:                  # a decay-only Fock, as the reference's
        idx = np.arange(N)          # drift test uses
        f = -np.exp(-0.4 * np.abs(np.subtract.outer(idx, idx)))
    else:
        f = ref_tests.TestSCF()._fock()
    s = ref_tests._spd("banded")
    dr, rr = _scf(repro, ref_solvers, f, s, tol=1e-6, filter_tol=filter_tol)
    dp, rp = _scf(repro_torch, port_solvers, f, s, tol=1e-6,
                  filter_tol=filter_tol)
    for k in ("sp2_iterations", "converged", "replay_tasks",
              "recompile_hits", "recompile_misses", "traces"):
        assert getattr(rp, k) == getattr(rr, k), k
    assert rp.occupation == pytest.approx(rr.occupation, abs=1e-10)
    np.testing.assert_allclose(dp, dr, atol=1e-10, rtol=0)
    assert rp.converged and abs(rp.occupation - N // 2) <= 1e-3
    want = ref_tests.TestSCF()._reference(f, s, N // 2)
    np.testing.assert_allclose(dp, want, atol=5e-3, rtol=5e-3)
    if filter_tol:
        assert rp.recompile_misses >= 1 and rp.recompile_hits >= 1
    else:
        assert rp.replay_tasks == 0 and rp.recompile_misses == 0


def test_scf_density_torch_engine():
    f, s = ref_tests.TestSCF()._fock(), ref_tests._spd("banded")
    dr, rr = _scf(repro, ref_solvers, f, s, tol=1e-6)
    dp, rp = _scf(repro_torch, port_solvers, f, s, tol=1e-6,
                  engine=TorchEngine(device="cpu"))
    assert rp.converged and rp.replay_tasks == 0
    assert abs(rp.occupation - N // 2) <= 1e-3
    assert rp.factor.residual <= 1e-4
    np.testing.assert_allclose(dp, dr, atol=5e-3, rtol=5e-3)


def _band(n, w, draw):
    """Symmetric banded matrix from one draw per diagonal entry."""
    a = np.zeros((n, n))
    for k in range(w + 1):
        i = np.arange(n - k)
        a[i, i + k] = a[i + k, i] = draw(k, n - k)
    return a


def test_scf_support_survives_float32_underflow():
    """Under float32 packing the far blocks of ``Zᵀ F Z`` underflow to
    exact zeros (the numpy engine keeps them, about 1e-270), so a plan
    compiled on the support of those values refuses the next iterate:
    SP2 fill-in drifts past it.  The port compiles the unfiltered iterate
    on full support: zero replay tasks, and D still matches."""
    n, leaf_n = 512, 128
    rng = np.random.default_rng(0)
    s = _band(n, 64, lambda k, m: (1.0 if k == 0 else
                                   rng.standard_normal(m) * 0.5 ** k))
    off = np.abs(s).sum(1) - 1.0
    s = s * (0.45 / off.max()) + np.eye(n) * (1.0 - 0.45 / off.max())
    f = _band(n, 64, lambda k, m: (-np.exp(-0.4 * k)
                                   + 0.05 * rng.standard_normal(m)))
    sess = repro_torch.Session(engine=TorchEngine(device="cpu"),
                               leaf_n=leaf_n, bs=32, lazy=True)
    S = sess.from_dense(s, upper=True)
    Z, _ = port_solvers.inverse_factor(S)
    fp = (Z.T @ sess.from_dense(f) @ Z).to_dense()
    blocks = np.abs(fp).reshape(n // 32, 32, n // 32, 32).max(axis=(1, 3))
    assert (blocks == 0).sum() > 0, "no block underflowed: nothing pinned"
    # the reference's rule: compile on the support of the values
    x0 = np.eye(n) - fp / np.abs(fp).sum(1).max()
    X = sess.from_dense(x0, name="X0")
    plan = sess.compile(X @ X)
    with pytest.raises(repro_torch.PlanStructureError):
        plan.run(X0=plan.run().to_dense())      # fill-in drifts past it
    d, rep = port_solvers.scf_density(sess, f, s, n // 4,
                                      tol=1e-6 * math.sqrt(n / 64))
    assert rep.converged and rep.replay_tasks == 0
    assert rep.recompile_misses == 0 and rep.recompile_hits == 0
    z = np.linalg.solve(np.linalg.cholesky(s).T, np.eye(n))
    _, v = np.linalg.eigh(z.T @ f @ z)
    c = v[:, :n // 4]
    np.testing.assert_allclose(d.to_dense(), z @ (c @ c.T) @ z.T,
                               atol=5e-3, rtol=5e-3)
