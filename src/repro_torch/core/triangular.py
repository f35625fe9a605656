"""Recursive triangular task programs: solve and inverse Cholesky.

The electronic-structure solver family (arXiv:1901.07993) needs two more
quadtree task programs beyond the multiply/add/sym set of
:mod:`repro_torch.core.multiply`:

* :func:`qt_inv_chol` — the recursive **inverse Cholesky** factorization
  of an SPD matrix S in symmetric upper storage: Z upper triangular with
  ``Z^T S Z = I``.  For the 2x2 block partition ``S = [[A, B], [B^T, C]]``

  .. math::

      Z = \\begin{pmatrix} Z_A & -Z_A (Z_A^T B) Z_C \\\\
                           0   & Z_C \\end{pmatrix},

  where ``Z_A = qt_inv_chol(A)`` and ``Z_C = qt_inv_chol(C - T^T T)``
  with ``T = Z_A^T B`` — the Schur complement ``C - B^T A^{-1} B``
  computed via ``A^{-1} = Z_A Z_A^T`` as a rank-k update (qt_syrk), so
  the correction stays in symmetric upper storage like C itself.

* :func:`qt_tri_solve` — recursive **triangular solve** ``X = R^{-1} B``
  with R upper triangular: the bottom block row solves against R11
  alone, the top one back-substitutes ``X0j = R00^{-1}(B0j - R01 X1j)``.

Both follow the structure of the existing symmetric programs: NIL
short-circuits at registration (zero subtrees of B cost nothing), leaf
tasks are :class:`~repro_torch.core.engine.LeafPayload` kinds (``inv_chol``,
``tri_solve``) so the deferred torch backend batches every ready leaf
of one shape into a single kernels/tri.py call, and internal levels are
create-from-identifier tasks.  Triangular results use *plain* storage
with the strictly-lower quadrant NIL at every level (they are
triangular, not symmetric), so downstream multiplies see an ordinary —
and notably sparse — quadtree.

A NIL diagonal block of the input is a singular matrix: both programs
raise instead of silently producing a NIL result.
"""
from __future__ import annotations

from typing import Optional

from .engine import LeafPayload
from .multiply import (_level_of, _register_create, qt_add, qt_multiply,
                       qt_scale, qt_syrk)
from .quadtree import CTGraph, MatrixChunk, QTParams
from .tasks import Alias, Dep

__all__ = ["qt_tri_solve", "qt_inv_chol", "SOLVE_TASK_KINDS"]

#: task kinds this module registers (for task-count assertions)
SOLVE_TASK_KINDS = ("tri_solve", "inv_chol")


def qt_tri_solve(g: CTGraph, params: QTParams, r: Optional[int],
                 b: Optional[int]) -> Optional[int]:
    """X = R^{-1} B; R upper triangular in plain storage (see module doc)."""
    if g.is_nil(b):
        return None
    if g.is_nil(r):
        raise ValueError(
            "qt_tri_solve: NIL triangular operand (singular matrix)")
    rc: MatrixChunk = g.value_of(r)
    bc: MatrixChunk = g.value_of(b)
    assert not rc.upper and not bc.upper and rc.n == bc.n
    level = _level_of(params, rc.n)

    if rc.is_leaf:
        nid = g.register_task(
            "tri_solve", None, [Dep(r), Dep(b)],
            payload=LeafPayload("tri_solve", a=r, b=b))
        g.nodes[nid].level = level
        return nid

    def fn(rv: MatrixChunk, bv: MatrixChunk):
        r00, r01, r10, r11 = rv.children
        assert g.is_nil(r10), "qt_tri_solve: R is not upper triangular"
        b00, b01, b10, b11 = bv.children
        x10 = qt_tri_solve(g, params, r11, b10)
        x11 = qt_tri_solve(g, params, r11, b11)
        # back substitution: X0j = R00^{-1} (B0j - R01 X1j)
        x00 = qt_tri_solve(g, params, r00, qt_add(
            g, params, b00,
            qt_scale(g, params, qt_multiply(g, params, r01, x10), -1.0)))
        x01 = qt_tri_solve(g, params, r00, qt_add(
            g, params, b01,
            qt_scale(g, params, qt_multiply(g, params, r01, x11), -1.0)))
        return Alias(_register_create(g, rv.n, (x00, x01, x10, x11), False,
                                      level))

    nid = g.register_task("tri_solve", fn, [Dep(r), Dep(b)])
    g.nodes[nid].level = level
    return nid


def qt_inv_chol(g: CTGraph, params: QTParams, s: Optional[int]
                ) -> Optional[int]:
    """Z upper triangular with Z^T S Z = I; S SPD in symmetric upper
    storage (see module doc for the recursion)."""
    if g.is_nil(s):
        raise ValueError(
            "qt_inv_chol: NIL matrix is singular (not positive definite)")
    sc: MatrixChunk = g.value_of(s)
    assert sc.upper
    level = _level_of(params, sc.n)

    if sc.is_leaf:
        nid = g.register_task(
            "inv_chol", None, [Dep(s)],
            payload=LeafPayload("inv_chol", a=s))
        g.nodes[nid].level = level
        return nid

    def fn(sv: MatrixChunk):
        s00, s01, _, s11 = sv.children
        za = qt_inv_chol(g, params, s00)
        # T = Z_A^T B; Schur correction B^T A^{-1} B = T^T T (upper)
        t = qt_multiply(g, params, za, s01, ta=True)
        corr = qt_scale(g, params, qt_syrk(g, params, t, trans=True), -1.0)
        zc = qt_inv_chol(g, params, qt_add(g, params, s11, corr))
        # off-diagonal Y = -Z_A T Z_C  (= -A^{-1} B Z_C)
        y = qt_scale(g, params, qt_multiply(
            g, params, za, qt_multiply(g, params, t, zc)), -1.0)
        return Alias(_register_create(g, sv.n, (za, y, None, zc), False,
                                      level))

    nid = g.register_task("inv_chol", fn, [Dep(s)])
    g.nodes[nid].level = level
    return nid
