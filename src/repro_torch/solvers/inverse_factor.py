"""Inverse factorization of an SPD overlap matrix: Z with Z^T S Z = I.

Three methods over the same quadtree substrate (arXiv:1901.07993):

``recursive``
    One shot through the :func:`~repro_torch.core.triangular.qt_inv_chol` task
    program — exact (up to leaf arithmetic), Z upper triangular.

``global``
    Iterative refinement from the scaled identity ``Z_0 = S /
    ||S||_F^{1/2}``-style guess ``Z_0 = c I`` with ``c = ||S||_F^{-1/2}``:

    .. math:: Z_{k+1} = Z_k (I + \\tfrac12 (I - M_k)),
              \\qquad M_k = Z_k^T S Z_k.

    Since ``lambda_max(S) <= ||S||_F`` the starting spectrum of ``M_0``
    lies in (0, 1], so ``||I - M_0||_2 < 1`` and the order-2 iteration
    converges for every SPD S (slowly when ill-conditioned — the point
    of the localized method).

``localized``
    The divide-and-conquer scheme: recursively factor the two diagonal
    principal submatrices (extracted as alias subtrees, no copies),
    stack them block-diagonally and run the *same* refinement — which
    now only has to build up the off-diagonal coupling.  With a decaying
    S the refinement multiplies are truncated (``tau``), so work
    concentrates near the diagonal: the report's ``multiply_tasks``
    ("touched subtrees") stays well below the global method's.

The refinement keeps S in symmetric upper storage (``S Z`` via the
untruncated sym_multiply program) and truncates the two plain products
``Z^T (S Z)`` and ``Z M`` — pruning follows Z's structure, where the
locality lives.  The residual is read back exactly:
``||M - I||_F^2 = ||M||_F^2 - 2 tr(M) + n`` (one frob2 + one trace, both
cached leaf reductions).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.api.matrix import Matrix
from repro_torch.core.multiply import _level_of, _register_create

__all__ = ["FactorReport", "inverse_factor"]

#: accepted ``method=`` spellings
METHODS = ("recursive", "localized", "global")


@dataclasses.dataclass
class FactorReport:
    """Typed account of one inverse factorization (DESIGN.md §11)."""
    method: str
    iterations: int                 # refinement iterations (all levels)
    residual: float                 # measured ||Z^T S Z - I||_F at exit
    tol: float
    converged: bool
    tau: float                      # refinement truncation threshold
    flops: float                    # leaf flops registered while factoring
    multiply_tasks: int             # multiply tasks registered ("touched
                                    # subtrees" of the refinement sweeps)
    residuals: list = dataclasses.field(default_factory=list)
    splits: int = 0                 # localized: recursive bisections taken

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["schema"] = 1
        return d


def _eye(like: Matrix) -> Matrix:
    """The identity at ``like``'s dimension and chunk parameters."""
    return like.session.from_dense(np.eye(like.n),
                                   leaf_n=like.params.leaf_n,
                                   bs=like.params.bs)


def _residual(s: Matrix, z: Matrix, tau: float, eye: Matrix
              ) -> tuple[Matrix, float]:
    """(M, ||M - I||_F) for M = Z^T S Z; one sym_multiply + one multiply.

    The residual is read as ``||M - I||_F`` through an explicit
    subtraction: the algebraically equivalent ``||M||_F^2 - 2 tr(M) + n``
    cancels O(n) quantities against each other and loses the entire
    signal once the factor is accurate.
    """
    w = s.sym_multiply(z)                   # S Z, untruncated
    m = z.T.multiply(w, tau=tau)
    return m, math.sqrt(max((m - eye).frob2(), 0.0))


def _refine(s: Matrix, z: Matrix, tol: float, max_iters: int, tau: float,
            residuals: list) -> tuple[Matrix, int, bool]:
    """Order-2 refinement Z <- Z (I + (I - M)/2) until ||M - I||_F <= tol."""
    eye = _eye(s)
    m, resid = _residual(s, z, tau, eye)
    residuals.append(resid)
    it = 0
    while resid > tol and it < max_iters:
        # Z_{k+1} = 1.5 Z - 0.5 Z M
        z = 1.5 * z - 0.5 * z.multiply(m, tau=tau)
        m, resid = _residual(s, z, tau, eye)
        residuals.append(resid)
        it += 1
    return z, it, resid <= tol


def _block_diag(a: Matrix, d: Matrix, like: Matrix) -> Matrix:
    """Stack two half-size factors block-diagonally at ``like``'s size.

    A single creation-from-identifiers task (§3.2): the halves' subtrees
    are shared, not copied, so a localized starting guess costs one task.
    """
    sess = like.session
    a._ensure()
    d._ensure()
    nid = _register_create(
        sess.graph, like.n, (a.node, None, None, d.node), False,
        _level_of(like.params, like.n))
    return Matrix(sess, nid, like.params, upper=False)


def _localized(s: Matrix, tol: float, max_iters: int, tau: float,
               split_n: int, residuals: list, state: dict) -> Matrix:
    if s.n <= split_n:
        return s.inv_chol()
    state["splits"] += 1
    z00 = _localized(s.principal_submatrix([0]), tol, max_iters, tau,
                     split_n, residuals, state)
    z11 = _localized(s.principal_submatrix([3]), tol, max_iters, tau,
                     split_n, residuals, state)
    z0 = _block_diag(z00, z11, s)
    z, it, ok = _refine(s, z0, tol, max_iters, tau, residuals)
    state["iterations"] += it
    state["converged"] = state["converged"] and ok
    return z


def inverse_factor(s: Matrix, method: str = "recursive",
                   tol: float = 1e-6, max_iters: int = 50,
                   tau: float = 0.0, split_n: Optional[int] = None
                   ) -> tuple[Matrix, FactorReport]:
    """Inverse factor Z of an SPD matrix S (symmetric upper storage).

    Parameters
    ----------
    s : SPD :class:`Matrix` built with ``upper=True``.
    method : ``"recursive"`` (exact one-shot), ``"localized"``
        (divide-and-conquer + truncated refinement) or ``"global"``
        (refinement from a scaled identity) — see module docstring.
    tol : refinement exit threshold on ``||Z^T S Z - I||_F`` (the
        recursive method ignores it and just reports its residual).
    max_iters : refinement iteration cap **per level**.
    tau : truncation threshold of the refinement's plain multiplies
        (0.0 = exact refinement).
    split_n : localized only — dimension at or below which a subproblem
        is factored directly (default: the quadtree leaf dimension).

    Returns ``(Z, FactorReport)``; Z satisfies ``Z^T S Z = I`` up to the
    report's measured ``residual``.
    """
    if not isinstance(s, Matrix):
        raise TypeError(f"inverse_factor: expected a Matrix, got {type(s)!r}")
    if not s.upper:
        raise ValueError("inverse_factor: S must use symmetric upper "
                         "storage (from_dense(..., upper=True))")
    if method not in METHODS:
        raise ValueError(f"inverse_factor: unknown method {method!r}; "
                         f"pick one of {METHODS}")
    sess = s.session
    flops0 = sess.flops
    mults0 = sess.n_multiply_tasks
    residuals: list = []
    iterations = 0
    converged = True
    splits = 0

    if method == "recursive":
        z = s.inv_chol()
    elif method == "global":
        c = 1.0 / math.sqrt(math.sqrt(s.frob2()))   # Z0 = I / ||S||_F^{1/2}
        z0 = c * sess.from_dense(np.eye(s.n), leaf_n=s.params.leaf_n,
                                 bs=s.params.bs)
        z, iterations, converged = _refine(s, z0, tol, max_iters, tau,
                                           residuals)
    else:                                           # localized
        state = {"iterations": 0, "converged": True, "splits": 0}
        z = _localized(s, tol, max_iters, tau,
                       split_n or s.params.leaf_n, residuals, state)
        iterations = state["iterations"]
        converged = state["converged"]
        splits = state["splits"]

    _, resid = _residual(s, z, 0.0, _eye(s))        # exit residual, exact
    report = FactorReport(
        method=method, iterations=iterations, residual=resid, tol=tol,
        converged=converged if method != "recursive" else True, tau=tau,
        flops=sess.flops - flops0,
        multiply_tasks=sess.n_multiply_tasks - mults0,
        residuals=residuals, splits=splits)
    return z, report
