"""Batched dense triangular ops for the solver leaf payloads.

The solver task programs (:mod:`repro_torch.core.triangular`) bottom out
in two leaf payload kinds — ``inv_chol`` (Z = U^{-1} for S = U^T U, the
leaf inverse Cholesky) and ``tri_solve`` (X = R^{-1} B with R upper
triangular).  The deferred torch engine batches every ready solve leaf of
one shape into a single call here.  As in the reference, these are the
framework's own batched factorizations (``torch.linalg``), not
hand-written kernels: the reference's ``kernels/tri.py`` is XLA code, not
Pallas.  The calls run on the device of their input.
"""
from __future__ import annotations

import torch

__all__ = ["batched_inv_chol", "batched_tri_solve", "batched_tri_inv"]


def batched_tri_inv(r: torch.Tensor, *, lower: bool = False) -> torch.Tensor:
    """inv(R[p]) for a stack of triangular matrices; (P, n, n) -> same."""
    eye = torch.eye(r.shape[-1], dtype=r.dtype, device=r.device).expand_as(r)
    return torch.linalg.solve_triangular(r, eye, upper=not lower)


def batched_inv_chol(s: torch.Tensor) -> torch.Tensor:
    """Z[p] = inv(chol_upper(S[p])): upper triangular, Z^T S Z = I.

    ``S`` is a (P, n, n) stack of dense symmetric positive-definite
    leaves (full storage — callers expand symmetric upper storage first).
    """
    u = torch.linalg.cholesky(s).mT      # S = L L^T = U^T U, U upper
    return batched_tri_inv(u, lower=False)


def batched_tri_solve(r: torch.Tensor, b: torch.Tensor, *,
                      lower: bool = False) -> torch.Tensor:
    """X[p] = inv(R[p]) @ B[p] with R triangular; both (P, n, n)."""
    return torch.linalg.solve_triangular(r, b, upper=not lower)
