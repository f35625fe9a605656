"""The density-matrix pipeline: S -> Z -> Z^T F Z -> SP2 -> D.

One self-consistent-field-style cycle of linear-scaling electronic
structure, composed entirely from the library's task programs:

1. **Inverse factorization** of the overlap matrix S
   (:func:`~repro_torch.solvers.inverse_factor.inverse_factor`): Z with
   ``Z^T S Z = I``.
2. **Congruence transformation** ``F_perp = Z^T F Z`` — the Fock matrix
   in the orthonormalized basis, built as a lazy two-multiply expression.
3. **SP2 purification** (Niklasson's trace-correcting polynomials): map
   the spectrum into [0, 1] with Gershgorin bounds, then iterate
   ``X <- X^2`` or ``X <- 2X - X^2`` — whichever step moves ``tr(X)``
   toward the occupation count — until ``X`` is idempotent.  Both
   polynomials are **compiled plans** (``X @ X`` and ``2X - Y``): every
   iteration rebind-replays with zero task registrations while the
   sparsity structure holds, and a drifting structure (``filter_tol``
   thresholding between iterations) takes the
   ``plan.run(recompile=True)`` path, exercising the successor cache
   (DESIGN.md §6) — hits and misses are surfaced on the report.
4. **Back transformation** ``D = Z D_perp Z^T``.

The session must be lazy (``Session(lazy=True)``): the pipeline's whole
point is plan reuse across iterations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.api.matrix import Matrix

from .inverse_factor import FactorReport, inverse_factor

__all__ = ["SCFReport", "scf_density"]


@dataclasses.dataclass
class SCFReport:
    """Account of one full density-matrix build (DESIGN.md §11)."""
    factor: FactorReport            # the S = (Z Z^T)^{-1} stage
    sp2_iterations: int
    idempotency: float              # ||X^2 - X||_F at exit (ortho basis)
    occupation: float               # tr(D_perp) — should be ~ n_occ
    converged: bool
    recompile_hits: int             # successor replays during drift
    recompile_misses: int           # fresh compiles during drift
    replay_tasks: int               # tasks registered by the *last*
                                    # unchanged-structure replay (0 = the
                                    # zero-task invariant held)
    traces: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["factor"] = self.factor.to_dict()
        d["schema"] = 1
        return d


def _gershgorin(a: np.ndarray) -> tuple[float, float]:
    """Outer bounds on the spectrum from Gershgorin discs."""
    d = np.diag(a)
    r = np.sum(np.abs(a), axis=1) - np.abs(d)
    return float(np.min(d - r)), float(np.max(d + r))


def scf_density(session, f: np.ndarray, s: np.ndarray, n_occ: int,
                method: str = "recursive", tol: float = 1e-6,
                factor_tol: float = 1e-8, tau: float = 0.0,
                max_iters: int = 60, filter_tol: float = 0.0
                ) -> tuple[Matrix, SCFReport]:
    """Density matrix D of Fock matrix F / overlap S at occupation n_occ.

    Parameters
    ----------
    session : a ``Session(lazy=True)`` (any engine).
    f, s : dense Fock and SPD overlap matrices (s is symmetrized and
        stored upper; quadtrees use the session's leaf_n/bs).
    n_occ : occupied-orbital count — the target ``tr(D_perp)``.
    method, factor_tol, tau : forwarded to :func:`inverse_factor`.
    tol : SP2 exit threshold on ``||X^2 - X||_F``.
    max_iters : SP2 iteration cap.
    filter_tol : threshold applied to the iterate between SP2 steps;
        nonzero values drift the sparsity structure and route iterations
        through ``recompile=True`` (0.0 keeps one frozen structure — the
        zero-new-tasks replay regime).

    Returns ``(D, SCFReport)`` with D in the original (non-orthonormal)
    basis.
    """
    if not session.lazy:
        raise ValueError("scf_density: needs a Session(lazy=True) — the "
                         "SP2 loop runs through compiled plans")
    f = np.asarray(f, dtype=np.float64)
    s = np.asarray(s, dtype=np.float64)
    n = f.shape[0]
    if f.shape != (n, n) or s.shape != (n, n):
        raise ValueError("scf_density: F and S must be square and "
                         f"same-shape, got {f.shape} and {s.shape}")

    # 1. inverse factorization of the overlap
    S = session.from_dense((s + s.T) / 2.0, upper=True)
    Z, frep = inverse_factor(S, method=method, tol=factor_tol, tau=tau)

    # 2. congruence transform into the orthonormal basis
    F = session.from_dense(f, name="F")
    f_perp = (Z.T @ F @ Z).to_dense()

    # 3. SP2: map spectrum into [0, 1], purify with compiled plans
    lo, hi = _gershgorin(f_perp)
    hi = hi if hi > lo else lo + 1.0
    x = (hi * np.eye(n) - f_perp) / (hi - lo)
    if filter_tol > 0.0:
        # threshold the starting iterate too: the plans compile on the
        # *sparse* structure, so purification fill-in genuinely drifts
        # past it (otherwise every filtered iterate is a subset of the
        # full-support compile and no rebind ever mismatches)
        x = np.where(np.abs(x) < filter_tol, 0.0, x)

    # without filtering, every iterate is a polynomial of X0, whose blocks
    # are structurally nonzero; under float32 packing the far blocks of
    # the congruence underflow to exact zeros, and a support read from
    # those values would let purification fill-in drift past the compiled
    # structure.  Compile on full support instead (tol < 0 keeps every
    # block), which is X0's support in float64 too
    support_tol = -1.0 if filter_tol == 0.0 else 0.0
    xs = session.from_dense(x, name="X", tol=support_tol)
    plan_sq = session.compile(xs @ xs)
    ys = session.from_dense(x, name="Y", tol=support_tol)
    plan_pol = session.compile(2.0 * xs - ys)
    hits0 = plan_sq._succ_hits + plan_pol._succ_hits
    miss0 = plan_sq._succ_misses + plan_pol._succ_misses

    traces: list = []
    replay_tasks = 0

    def run_counted(plan, **bindings) -> np.ndarray:
        # once a plan is compiled, a structure-preserving run must
        # register zero tasks; accumulate any violation for the report
        nonlocal replay_tasks
        compiled = plan.nodes is not None
        n_before = len(session.graph.nodes)
        out = plan.run(recompile=True, **bindings).to_dense()
        if compiled and filter_tol == 0.0:
            replay_tasks += len(session.graph.nodes) - n_before
        return out

    idem = math.inf
    it = 0
    while it < max_iters:
        x2 = run_counted(plan_sq, X=x)
        tr_x = float(np.trace(x))
        tr_x2 = float(np.trace(x2))
        traces.append(tr_x)
        idem = float(np.linalg.norm(x2 - x))
        if idem <= tol:
            break
        # trace-correcting branch: keep X^2 when it moves tr toward
        # n_occ, else apply 2X - X^2
        if abs(tr_x2 - n_occ) <= abs(2.0 * tr_x - tr_x2 - n_occ):
            x = x2
        else:
            x = run_counted(plan_pol, X=x, Y=x2)
        if filter_tol > 0.0:
            x = np.where(np.abs(x) < filter_tol, 0.0, x)
        it += 1

    # 4. back transformation D = Z X Z^T
    D_perp = session.from_dense(x)
    D = Z @ D_perp @ Z.T

    report = SCFReport(
        factor=frep, sp2_iterations=it, idempotency=idem,
        occupation=float(np.trace(x)), converged=idem <= tol,
        recompile_hits=(plan_sq._succ_hits + plan_pol._succ_hits - hits0),
        recompile_misses=(plan_sq._succ_misses + plan_pol._succ_misses
                          - miss0),
        replay_tasks=replay_tasks, traces=traces)
    return D, report
