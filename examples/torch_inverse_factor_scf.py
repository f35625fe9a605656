"""Inverse factorization + one SCF density build on the port's solvers.

    PYTHONPATH=src python examples/torch_inverse_factor_scf.py [--device cpu]

The PyTorch/CUDA counterpart of ``examples/inverse_factor_scf.py``: the
full linear-scaling electronic-structure pipeline (DESIGN.md §11) in one
walkthrough, on a banded SPD overlap matrix S and a decaying Fock matrix
F, every multiply a ``bsmm_pairs`` wave on the card:

1. **Inverse factorization** — three routes to Z with ``Z^T S Z = I``:
   the one-shot recursive inverse Cholesky (``qt_inv_chol`` task
   program), iterative refinement from a scaled identity ("global"),
   and the divide-and-conquer "localized" scheme (arXiv:1901.07993)
   that factors the diagonal principal submatrices first and lets the
   truncated refinement build up only the off-diagonal coupling.  On a
   decaying S the localized method touches far fewer multiply subtrees.

2. **Accuracy-scaled chain** — the congruence ``Z^T F Z`` evaluated as
   a :func:`repro_torch.solvers.multiply_chain` under a
   :class:`repro_torch.solvers.TauPolicy`: state one target error for the
   whole product and each step's truncation threshold is derived, with
   the rigorous accumulated bound reported back.

3. **SCF density** — :func:`repro_torch.solvers.scf_density` composes
   factorization, congruence, compiled-plan SP2 purification and back
   transformation; the unchanged-structure replays register zero new
   tasks.  The result is checked against a dense eigendecomposition.

``--device cpu`` runs the numpy engine (float64) with the reference's
checks.  On the card the leaves are float32, and the checks take the
reference's float32 tolerances (tests/test_solvers.py): the reported
residual within 1e-4 of the dense one, the chain's error within its
bound plus 1e-3, the SP2 exit at 1e-6 (float32 cannot reach the float64
run's 1e-8) and D within 5e-3 of the dense reference.
"""
import argparse

import numpy as np

from repro_torch import Session
from repro_torch.solvers import TauPolicy, inverse_factor, \
    multiply_chain, scf_density

N, LEAF_N, BS = 64, 16, 4
#: (residual agreement, chain slack, SP2 tol, density error) per engine
TOLS = {"numpy": (1e-9, 0.0, 1e-8, 1e-5), "torch": (1e-4, 1e-3, 1e-6, 5e-3)}


def make_overlap(n: int, seed: int = 0) -> np.ndarray:
    """Diagonally dominant banded SPD overlap with exponential decay."""
    rng = np.random.default_rng(seed)
    dist = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
    a = rng.standard_normal((n, n)) * 0.5 ** dist
    a = (a + a.T) / 2.0
    off = np.abs(a).sum(axis=1) - np.abs(np.diag(a))
    a *= 0.45 / max(off.max(), 1e-12)
    np.fill_diagonal(a, 1.0)
    return a


def make_fock(n: int, seed: int = 1) -> np.ndarray:
    idx = np.arange(n)
    f = -np.exp(-0.4 * np.abs(idx[:, None] - idx[None, :]))
    noise = np.random.default_rng(seed).standard_normal((n, n)) * 0.05
    return (f + f.T) / 2.0 + (noise + noise.T) / 2.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the torch engine on the card; cpu: the "
                         "numpy engine")
    engine = "torch" if ap.parse_args().device == "cuda" else "numpy"
    tol_resid, slack, sp2_tol, tol_d = TOLS[engine]
    s = make_overlap(N)
    f = make_fock(N)
    n_occ = N // 4

    # --- 1. three inverse-factorization methods -------------------------
    print(f"inverse factorization of S (n={N}, banded SPD):")
    print("  method     iters  residual   multiply tasks")
    tasks = {}
    for method in ("recursive", "localized", "global"):
        sess = Session(engine=engine, leaf_n=LEAF_N, bs=BS)
        S = sess.from_dense(s, upper=True)
        z, rep = inverse_factor(S, method=method, tol=1e-4, tau=1e-7)
        zd = z.to_dense()
        resid = np.linalg.norm(zd.T @ s @ zd - np.eye(N))
        assert resid <= rep.residual + tol_resid
        tasks[method] = rep.multiply_tasks
        print(f"  {method:<10} {rep.iterations:>5}  {rep.residual:.2e}"
              f"   {rep.multiply_tasks}")
    assert tasks["localized"] < tasks["global"], \
        "localized refinement should touch fewer subtrees than global"
    print(f"  localized touched {tasks['localized']}/{tasks['global']} "
          f"of the global method's subtrees")

    # --- 2. accuracy-scaled congruence chain Z^T F Z --------------------
    sess = Session(engine=engine, leaf_n=LEAF_N, bs=BS)
    Z, _ = inverse_factor(sess.from_dense(s, upper=True))
    target = 1e-5
    prod, crep = multiply_chain(
        [Z.T, sess.from_dense(f), Z], policy=TauPolicy(target=target))
    zd = Z.to_dense()
    err = np.linalg.norm(prod.to_dense() - zd.T @ f @ zd)
    assert err <= crep.accumulated_bound + slack
    assert crep.accumulated_bound <= target
    print(f"\ncongruence chain Z^T F Z under TauPolicy(target={target:g}):")
    print(f"  derived taus {['%.1e' % t for t in crep.taus]}, "
          f"accumulated bound {crep.accumulated_bound:.2e}, "
          f"measured error {err:.2e}")

    # --- 3. the full SCF density build ----------------------------------
    sess = Session(engine=engine, lazy=True, leaf_n=LEAF_N, bs=BS)
    D, rep = scf_density(sess, f, s, n_occ, tol=sp2_tol)
    d = D.to_dense()

    # dense reference: generalized eigenproblem via the Cholesky factor
    z_ref = np.linalg.solve(np.linalg.cholesky(s).T, np.eye(N))
    w, v = np.linalg.eigh(z_ref.T @ f @ z_ref)
    d_ref = z_ref @ v[:, :n_occ] @ v[:, :n_occ].T @ z_ref.T
    err = np.linalg.norm(d - d_ref)
    assert err < tol_d, f"density matrix off by {err:.2e}"
    assert rep.converged and rep.replay_tasks == 0
    print(f"\nscf_density: {rep.sp2_iterations} SP2 iterations, "
          f"idempotency {rep.idempotency:.2e}, "
          f"occupation {rep.occupation:.4f} (target {n_occ})")
    print(f"  compiled-plan replays registered {rep.replay_tasks} new "
          f"tasks; ||D - D_eig||_F = {err:.2e}: OK")


if __name__ == "__main__":
    main()
