"""Matrix: operator-overloaded handle over a quadtree chunk hierarchy.

A :class:`Matrix` wraps ``(session, root node id, QTParams)`` plus two
bits of algebraic state — a **lazy transpose flag** and the symmetric
**upper-storage** marker.  Operators no longer call the ``qt_*`` layer
directly: every operation builds an :mod:`~repro_torch.api.expr` node and hands
it to the session, which lowers it through the rewrite pipeline of
:mod:`repro_torch.api.plan` —

* **eagerly** (``Session(lazy=False)``, default): at once, registering a
  task program byte-identical to the pre-IR facade (pinned by
  tests/test_api.py and tests/test_expr_plan.py);
* **lazily** (``Session(lazy=True)``): on first readback, as a compiled,
  cached, re-executable :class:`~repro_torch.api.plan.Plan`.

Operator surface:

* ``C = A @ B`` / ``A.multiply(B, tau=)`` — Algorithm 1 with transpose
  flags folded in; symmetric upper operands auto-route to sym_multiply.
* ``A + B``, ``A - B`` — Algorithm 2 (subtraction lowers through the
  ``scale`` task program).
* ``alpha * A`` / ``A * alpha`` / ``-A`` — scalar scaling.
* ``A.T`` — lazy flag (no task) on materialised handles, a folded
  ``Transpose`` node on pending ones; symmetric matrices return self.
* ``A.sym_square()`` / ``A.syrk()`` / ``S.sym_multiply(B, side=)`` — the
  §3.3 symmetric task programs.  These are **untruncated**: a nonzero
  effective tau (explicit or session default) raises instead of silently
  computing an exact result (see :meth:`sym_square`).

Readback (:meth:`to_dense`, :meth:`frob2`, :meth:`trace`,
:meth:`nnz_blocks`, :meth:`stats`) forces pending expressions and flushes
deferred kernel leaf waves, so the handle is always safe to inspect.  NIL
(all-zero) matrices are first-class: their root id is None and every
operation short-circuits exactly as the fallback-execute semantics of
Algorithms 1-2 prescribe.
"""
from __future__ import annotations

import numbers
from typing import Optional

import numpy as np

from repro_torch.core.multiply import TruncationReport
from repro_torch.core.quadtree import (QTParams, qt_extract, qt_frob2, qt_norm2,
                                 qt_stats, qt_to_dense, qt_trace)

from .expr import (Add, Expr, Input, InvChol, MatMul, Scale, SymMul,
                   SymSquare, Syrk, Transpose, TriSolve, expr_upper)

_SYM_TAU_ERROR = (
    "{op}: the symmetric task programs are untruncated, but the effective "
    "truncation threshold is tau={tau!r} ({src}); pass tau=0 explicitly "
    "to compute exactly, or rebuild the operand as a plain (non-upper) "
    "matrix for a truncated multiply")


def _tau_src(explicit: bool) -> str:
    return "passed explicitly" if explicit else "from the Session default"


class Matrix:
    """Handle to a quadtree matrix registered in a session's task graph."""

    __slots__ = ("session", "node", "params", "_t", "upper", "_trunc",
                 "_expr", "name", "_prog", "__weakref__")

    def __init__(self, session, node: Optional[int], params: QTParams,
                 t: bool = False, upper: bool = False,
                 trunc: Optional[TruncationReport] = None,
                 expr: Optional[Expr] = None, name: Optional[str] = None):
        self.session = session
        self.node = node            # root chunk's node id; None == NIL
        self.params = params
        self._t = t and not upper   # symmetric storage: A == Aᵀ
        self.upper = upper
        self._trunc = trunc         # TruncationReport of the producing multiply
        self._expr = expr           # pending Expr (lazy mode) or None
        self.name = name            # plan input-slot name (rebinding)
        self._prog = None           # eager producing-program nid range (free)
        session._handles.add(self)  # Session.free keeps what it reads

    # -- construction (delegates to the session) ----------------------------
    @classmethod
    def from_dense(cls, session, a: np.ndarray, **kw) -> "Matrix":
        """``Matrix.from_dense(sess, a)`` == ``sess.from_dense(a)``."""
        return session.from_dense(a, **kw)

    @classmethod
    def from_pattern(cls, session, rows, cols, n: int, **kw) -> "Matrix":
        """Build from nonzero coordinates (no dense detour)."""
        return session.from_pattern(rows, cols, n, **kw)

    # -- bookkeeping ---------------------------------------------------------
    @property
    def n(self) -> int:
        """Global matrix dimension."""
        return self.params.n

    @property
    def is_lazy(self) -> bool:
        """True while this handle is an unevaluated expression."""
        return self._expr is not None

    @property
    def is_nil(self) -> bool:
        """True for the all-zero matrix (NIL chunk id at the root)."""
        self._ensure()
        return self.session.graph.is_nil(self.node)

    def __repr__(self) -> str:
        if self._expr is not None:
            return (f"Matrix(n={self.n}, "
                    f"lazy {type(self._expr).__name__} expression)")
        flags = "".join([".T" if self._t else "",
                         ", upper" if self.upper else "",
                         ", NIL" if self.node is None else ""])
        return f"Matrix(n={self.n}, node={self.node}{flags})"

    def _check(self, other: "Matrix", op: str) -> None:
        if not isinstance(other, Matrix):
            raise TypeError(f"{op}: expected a Matrix, got {type(other)!r}")
        if other.session is not self.session:
            raise ValueError(f"{op}: operands belong to different Sessions")
        if other.params != self.params:
            raise ValueError(f"{op}: operand quadtree parameters differ "
                             f"({self.params} vs {other.params})")

    def _ensure(self) -> None:
        """Force a pending expression (lazy mode) before readback."""
        if self._expr is not None:
            self.session._force(self)

    def _as_expr(self) -> Expr:
        """This handle as an Expr operand (pending state or bound input)."""
        if self._expr is not None:
            return self._expr
        e: Expr = Input(self.node, self.params.n, self.upper)
        return Transpose(e) if self._t else e

    def _result(self, e: Expr) -> "Matrix":
        """Hand a freshly-built op expression to the session."""
        if self.session.lazy:
            return Matrix(self.session, None, self.params,
                          upper=expr_upper(e), expr=e)
        return self.session._run_expr(e, self.params)

    # -- algebra -------------------------------------------------------------
    @property
    def T(self) -> "Matrix":
        """Lazy transpose: flips a flag (materialised handles) or wraps a
        folded ``Transpose`` node (pending ones); registers no task.  The
        flag is folded into the next multiply (Algorithm 1's op(A) op(B)).
        """
        if self.upper:
            return self             # symmetric: A == Aᵀ
        if self._expr is not None:
            return Matrix(self.session, None, self.params,
                          expr=Transpose(self._expr))
        return Matrix(self.session, self.node, self.params, t=not self._t,
                      trunc=self._trunc)

    def transpose(self) -> "Matrix":
        return self.T

    def __matmul__(self, other: "Matrix") -> "Matrix":
        """C = A B; a ``Session(tau=...)`` default makes this the
        error-controlled truncated multiply (see :meth:`multiply`)."""
        return self.multiply(other)

    def multiply(self, other: "Matrix", tau: Optional[float] = None
                 ) -> "Matrix":
        """C = op(A) op(B) with SpAMM-style hierarchical norm truncation.

        ``tau`` (default: the session's ``tau``) prunes every recursive
        product — at any quadtree level and within leaf block pairs —
        whose Frobenius-norm product is below it.  The result carries a
        :class:`~repro_torch.core.multiply.TruncationReport`; read the
        worst-case ``||C_exact - C_tau||_F`` bound via
        :attr:`error_bound`.  ``tau=0`` registers a task graph identical
        to the exact multiply.  Truncation applies to plain operands
        only; symmetric upper-storage operands route to the *untruncated*
        ``sym_multiply`` task program, so any nonzero effective tau —
        explicit or the session default — raises.
        """
        self._check(other, "@")
        explicit = tau is not None
        tau = float(self.session.tau if tau is None else tau)
        if self.upper and other.upper:
            raise ValueError(
                "@: both operands use symmetric upper storage; the library "
                "multiplies symmetric x plain (qt_sym_multiply). Rebuild "
                "one operand without upper=True")
        if self.upper or other.upper:
            if tau > 0.0:
                raise ValueError(
                    "multiply(tau=...): truncation needs plain (non-upper) "
                    "operands; " + _SYM_TAU_ERROR.format(
                        op="sym_multiply", tau=tau,
                        src=_tau_src(explicit)))
            return self._result(MatMul(self._as_expr(), other._as_expr()))
        return self._result(
            MatMul(self._as_expr(), other._as_expr(), tau=tau))

    def __add__(self, other: "Matrix") -> "Matrix":
        self._check(other, "+")
        if self.upper != other.upper:
            raise ValueError("+: cannot mix symmetric upper storage and "
                             "plain matrices; rebuild one operand")
        return self._result(Add((self._as_expr(), other._as_expr())))

    def __sub__(self, other: "Matrix") -> "Matrix":
        """C = A - B, lowered as A + (-1) * B (scale + add programs)."""
        self._check(other, "-")
        if self.upper != other.upper:
            raise ValueError("-: cannot mix symmetric upper storage and "
                             "plain matrices; rebuild one operand")
        return self._result(
            Add((self._as_expr(), Scale(-1.0, other._as_expr()))))

    def __mul__(self, alpha) -> "Matrix":
        """C = alpha * A for a scalar alpha (scale task program)."""
        if not isinstance(alpha, numbers.Number):
            return NotImplemented
        return self._result(Scale(float(alpha), self._as_expr()))

    __rmul__ = __mul__

    def __neg__(self) -> "Matrix":
        return self._result(Scale(-1.0, self._as_expr()))

    def sym_square(self, tau: Optional[float] = None) -> "Matrix":
        """C = A² for symmetric A in upper storage (paper §3.3): half the
        multiplies of a general product.

        The symmetric task programs are untruncated: if the session's
        ``tau`` default is nonzero this raises unless ``tau=0`` is passed
        explicitly — silently computing an exact result under a session
        configured for truncation would misreport the error bound.
        """
        if not self.upper:
            raise ValueError("sym_square needs symmetric upper storage: "
                             "build with from_dense(..., upper=True)")
        self._check_sym_tau(tau, "sym_square")
        return self._result(SymSquare(self._as_expr()))

    def syrk(self, trans: bool = False, tau: Optional[float] = None
             ) -> "Matrix":
        """C = A Aᵀ (or Aᵀ A with ``trans=True``); C in upper storage.
        Untruncated — see :meth:`sym_square` for the tau contract."""
        if self.upper:
            raise ValueError("syrk of a symmetric matrix is sym_square")
        self._check_sym_tau(tau, "syrk")
        return self._result(Syrk(self._as_expr(), trans=trans))

    def sym_multiply(self, other: "Matrix", side: str = "left",
                     tau: Optional[float] = None) -> "Matrix":
        """C = S B (``side="left"``) or B S (``side="right"``); self is the
        symmetric upper-storage S.  Untruncated — see :meth:`sym_square`
        for the tau contract."""
        self._check(other, "sym_multiply")
        if not self.upper or other.upper:
            raise ValueError("sym_multiply: self must be symmetric upper "
                             "storage and other plain")
        self._check_sym_tau(tau, "sym_multiply")
        return self._result(
            SymMul(self._as_expr(), other._as_expr(), side))

    # -- triangular algebra (solver-suite task programs) ---------------------
    def inv_chol(self) -> "Matrix":
        """Z with ``Z^T S Z = I`` — the recursive inverse Cholesky factor
        of an SPD matrix in symmetric upper storage (arXiv:1901.07993).
        The result is upper triangular in *plain* storage (strictly-lower
        quadrants NIL at every level); raises on a NIL (singular) input.
        """
        if not self.upper:
            raise ValueError("inv_chol needs symmetric upper storage: "
                             "build with from_dense(..., upper=True)")
        return self._result(InvChol(self._as_expr()))

    def tri_solve(self, b: "Matrix") -> "Matrix":
        """X = R^{-1} B with self an upper-triangular R in plain storage
        (e.g. a Cholesky factor); recursive back substitution."""
        self._check(b, "tri_solve")
        if self.upper or b.upper:
            raise ValueError("tri_solve: both operands must use plain "
                             "storage (R upper triangular, B general)")
        if self._t:
            raise ValueError("tri_solve: transposed R is not supported "
                             "(the recursion needs upper-triangular R)")
        return self._result(TriSolve(self._as_expr(), b._as_expr()))

    def principal_submatrix(self, path) -> "Matrix":
        """The principal submatrix at a quadrant ``path`` (sequence of
        indices 0..3 descending the quadtree), as a new Matrix over the
        smaller parameter set.  The extraction is a single alias task —
        subtree chunks (and their cached norms) are shared, not copied.
        Only the two diagonal quadrants (0 and 3) of a symmetric
        upper-storage matrix are themselves principal submatrices."""
        self._ensure()
        if self._t:
            raise ValueError("principal_submatrix: resolve the transpose "
                             "first (extract from the untransposed handle)")
        if self.upper and any(q not in (0, 3) for q in path):
            raise ValueError(
                "principal_submatrix: symmetric upper storage only has "
                "principal submatrices along the diagonal (quadrants 0/3)")
        nid, sub = qt_extract(self.session.graph, self.params, self.node,
                              path)
        return Matrix(self.session, nid, sub, upper=self.upper)

    def _check_sym_tau(self, tau: Optional[float], op: str) -> None:
        eff = float(self.session.tau if tau is None else tau)
        if eff > 0.0:
            raise ValueError(_SYM_TAU_ERROR.format(
                op=op, tau=eff, src=_tau_src(tau is not None)))

    # -- readback (forces lazy exprs, flushes deferred engine waves) ---------
    def to_dense(self) -> np.ndarray:
        """Dense numpy array (symmetric storage expands to the full
        matrix); forces pending expressions and flushes kernel waves."""
        self._ensure()
        d = qt_to_dense(self.session.graph, self.node, self.params)
        return np.ascontiguousarray(d.T) if self._t else d

    def frob2(self) -> float:
        """Squared Frobenius norm (transpose-invariant)."""
        self._ensure()
        return qt_frob2(self.session.graph, self.node)

    def norm2(self) -> float:
        """Cached squared Frobenius norm (the SpAMM pruning quantity);
        numerically identical to :meth:`frob2`."""
        self._ensure()
        return qt_norm2(self.session.graph, self.node)

    def trace(self) -> float:
        """Trace, via a cached leaf-level diagonal reduction
        (:func:`~repro_torch.core.quadtree.qt_trace`) — the SP2 purification
        control quantity.  Transpose-invariant."""
        self._ensure()
        return qt_trace(self.session.graph, self.node)

    # -- truncation readback --------------------------------------------------
    @property
    def truncation(self) -> Optional[TruncationReport]:
        """The :class:`~repro_torch.core.multiply.TruncationReport` of the
        multiply that produced this matrix, or None for other origins."""
        self._ensure()
        return self._trunc

    @property
    def error_bound(self) -> float:
        """Worst-case ``||C_exact - C_tau||_F`` of the producing truncated
        multiply; 0.0 for exact results (tau=0 prunes nothing)."""
        self._ensure()
        return self._trunc.error_bound if self._trunc is not None else 0.0

    def stats(self) -> dict:
        """Chunk/occupancy statistics of the quadtree (leaf chunks,
        internal chunks, nonzero blocks, bytes, depth)."""
        self._ensure()
        self.session.flush()
        return qt_stats(self.session.graph, self.node)

    def nnz_blocks(self) -> int:
        """Number of nonzero leaf blocks."""
        return self.stats()["nnz_blocks"]
