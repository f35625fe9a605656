"""Expr: the lazy expression IR behind the Session/Matrix facade.

Matrix operators build a lightweight :class:`Expr` DAG instead of emitting
``qt_*`` tasks directly; :mod:`repro_torch.api.plan` lowers a rewritten Expr into
the documented task programs.  Both facade modes share this layer:

* **eager** (``Session(lazy=False)``, the default): every operator call
  builds a one-op Expr over already-materialised operands and lowers it
  immediately — byte-for-byte the task registrations of the pre-IR facade.
* **lazy** (``Session(lazy=True)``): operators return unevaluated handles;
  readback (or an explicit :meth:`Session.compile`) runs the whole DAG
  through the rewrite pipeline below first, enabling cross-operation
  rewrites and compiled-:class:`~repro_torch.api.plan.Plan` reuse.

Expr nodes are immutable (frozen dataclasses) and compare by value, which
is what makes common-subexpression elimination a dict lookup during
lowering and plan caching a fingerprint comparison.

Rewrite pipeline (:func:`rewrite`, bottom-up, confluent by construction):

* **generalized transpose folding** — ``T(T(x)) = x``; ``T`` of symmetric
  upper storage is the identity; ``T`` commutes with ``Scale``; ``T`` of a
  product folds into Algorithm 1's op flags (``(A B)^T = B^T A^T`` becomes
  an op-flag swap, no transpose tasks); ``T`` of ``SymSquare``/``Syrk``
  results (symmetric) is the identity; ``T`` of ``SymMul`` flips its side.
* **sym-routing** — a symmetric upper-storage operand of ``MatMul`` routes
  to ``SymMul`` exactly as the eager facade always did.
* **add-chain flattening** — nested ``Add`` terms flatten into one n-ary
  node (lowered left-associatively, matching the eager binary adds), and
  an all-transposed add hoists the transpose: ``T(a) + T(b) = T(a + b)``.
* **scale folding** — ``Scale(a, Scale(b, x)) = Scale(a*b, x)``;
  ``Scale(1, x) = x``.

Truncation is planned per node: every ``MatMul`` carries its own ``tau``
(resolved from the call site / session default at build time), so one
expression may mix exact and truncated products.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Expr", "Input", "Transpose", "Scale", "Add", "MatMul",
           "SymSquare", "Syrk", "SymMul", "InvChol", "TriSolve", "rewrite",
           "expr_upper", "expr_inputs", "fingerprint"]


@dataclasses.dataclass(frozen=True)
class Expr:
    """Base of the expression IR; all nodes are immutable value types."""


@dataclasses.dataclass(frozen=True)
class Input(Expr):
    """A bound operand: the root node id of a materialised quadtree.

    ``nid is None`` is the NIL (all-zero) matrix.  Two Inputs are equal
    iff they reference the same chunk tree, so ``X @ X`` and ``X @ Y``
    compile to different plans even when X and Y share structure.
    """
    nid: Optional[int]
    n: int
    upper: bool = False


@dataclasses.dataclass(frozen=True)
class Transpose(Expr):
    a: Expr


@dataclasses.dataclass(frozen=True)
class Scale(Expr):
    alpha: float
    a: Expr


@dataclasses.dataclass(frozen=True)
class Add(Expr):
    terms: tuple     # >= 2 Exprs; lowered left-associatively


@dataclasses.dataclass(frozen=True)
class MatMul(Expr):
    a: Expr
    b: Expr
    ta: bool = False
    tb: bool = False
    tau: float = 0.0


@dataclasses.dataclass(frozen=True)
class SymSquare(Expr):
    a: Expr


@dataclasses.dataclass(frozen=True)
class Syrk(Expr):
    a: Expr
    trans: bool = False


@dataclasses.dataclass(frozen=True)
class SymMul(Expr):
    s: Expr
    b: Expr
    side: str = "left"


@dataclasses.dataclass(frozen=True)
class InvChol(Expr):
    """Inverse Cholesky factor Z of an SPD operand: Z^T a Z = I.

    ``a`` must lower to symmetric upper storage; the result is upper
    *triangular* in plain storage (strictly-lower quadrant NIL).
    """
    a: Expr


@dataclasses.dataclass(frozen=True)
class TriSolve(Expr):
    """X = r^{-1} b with r upper triangular (plain storage)."""
    r: Expr
    b: Expr


def expr_upper(e: Expr) -> bool:
    """Whether an expression's result uses symmetric upper storage."""
    if isinstance(e, Input):
        return e.upper
    if isinstance(e, (SymSquare, Syrk)):
        return True
    if isinstance(e, (MatMul, SymMul, InvChol, TriSolve)):
        return False
    if isinstance(e, Transpose):
        return expr_upper(e.a)
    if isinstance(e, Scale):
        return expr_upper(e.a)
    if isinstance(e, Add):
        return expr_upper(e.terms[0])
    raise TypeError(f"not an Expr: {e!r}")


def expr_inputs(e: Expr) -> list:
    """Distinct :class:`Input` nodes in deterministic first-visit order."""
    seen: dict[Input, None] = {}

    def walk(x: Expr) -> None:
        if isinstance(x, Input):
            seen.setdefault(x)
        elif isinstance(x, Transpose):
            walk(x.a)
        elif isinstance(x, Scale):
            walk(x.a)
        elif isinstance(x, Add):
            for t in x.terms:
                walk(t)
        elif isinstance(x, MatMul):
            walk(x.a)
            walk(x.b)
        elif isinstance(x, SymSquare):
            walk(x.a)
        elif isinstance(x, Syrk):
            walk(x.a)
        elif isinstance(x, SymMul):
            walk(x.s)
            walk(x.b)
        elif isinstance(x, InvChol):
            walk(x.a)
        elif isinstance(x, TriSolve):
            walk(x.r)
            walk(x.b)
        else:
            raise TypeError(f"not an Expr: {x!r}")

    walk(e)
    return list(seen)


# ---------------------------------------------------------------------------
# Rewrite pipeline
# ---------------------------------------------------------------------------

def rewrite(e: Expr) -> Expr:
    """Normalise an expression (see the module docstring for the rules).

    Idempotent; single-op expressions built by the eager facade are
    already in normal form, so eager lowering pays only the walk.
    """
    if isinstance(e, Input):
        return e
    if isinstance(e, Transpose):
        return _fold_transpose(rewrite(e.a))
    if isinstance(e, Scale):
        a = rewrite(e.a)
        alpha = e.alpha
        while isinstance(a, Scale):
            alpha *= a.alpha
            a = a.a
        if alpha == 1.0:
            return a
        if isinstance(a, Transpose):
            # keep transposes outermost so they peel into the handle's
            # lazy flag instead of materialising a transpose program
            return Transpose(Scale(alpha, a.a))
        return Scale(alpha, a)
    if isinstance(e, Add):
        terms: list = []
        for t in e.terms:
            t = rewrite(t)
            if isinstance(t, Add):
                terms.extend(t.terms)   # associativity: flatten the chain
            else:
                terms.append(t)
        if len(terms) > 1 and all(isinstance(t, Transpose) for t in terms):
            # T(a) + T(b) = T(a + b): one materialised transpose, not N
            return Transpose(Add(tuple(t.a for t in terms)))
        return Add(tuple(terms)) if len(terms) > 1 else terms[0]
    if isinstance(e, MatMul):
        a, ta = _strip_transpose(rewrite(e.a), e.ta)
        b, tb = _strip_transpose(rewrite(e.b), e.tb)
        if expr_upper(a) or expr_upper(b):
            if e.tau > 0.0:
                # mirror the facade contract for hand-built Exprs: the
                # symmetric task programs are untruncated, so a nonzero
                # tau must fail loudly, not be silently dropped
                raise ValueError(
                    "MatMul(tau>0) with a symmetric upper-storage "
                    "operand routes to the untruncated sym_multiply; "
                    "build the expression with tau=0 or plain operands")
            if expr_upper(a):   # sym-routing: C = S B (S^T = S, ta moot)
                return SymMul(a, Transpose(b) if tb else b, "left")
            return SymMul(b, Transpose(a) if ta else a, "right")  # C = B S
        return MatMul(a, b, ta=ta, tb=tb, tau=e.tau)
    if isinstance(e, SymSquare):
        return SymSquare(rewrite(e.a))
    if isinstance(e, Syrk):
        a, trans = _strip_transpose(rewrite(e.a), e.trans)
        return Syrk(a, trans=trans)
    if isinstance(e, SymMul):
        return SymMul(rewrite(e.s), rewrite(e.b), e.side)
    if isinstance(e, InvChol):
        return InvChol(rewrite(e.a))
    if isinstance(e, TriSolve):
        return TriSolve(rewrite(e.r), rewrite(e.b))
    raise TypeError(f"not an Expr: {e!r}")


def _strip_transpose(e: Expr, flag: bool) -> tuple[Expr, bool]:
    """Fold any leading Transpose chain into an op flag."""
    while isinstance(e, Transpose) and not expr_upper(e.a):
        e = e.a
        flag = not flag
    if isinstance(e, Transpose):    # transpose of symmetric storage: id
        e = e.a
    return e, flag


def _fold_transpose(a: Expr) -> Expr:
    """Normal form of ``Transpose(a)`` for an already-rewritten ``a``."""
    if expr_upper(a):
        return a                                # A = A^T
    if isinstance(a, Transpose):
        return a.a                              # T(T(x)) = x
    if isinstance(a, Scale):                    # (alpha x)^T = alpha x^T
        inner = _fold_transpose(a.a)
        if isinstance(inner, Transpose):        # keep T outermost
            return Transpose(Scale(a.alpha, inner.a))
        return Scale(a.alpha, inner)
    if isinstance(a, MatMul):                   # (A B)^T = B^T A^T
        return MatMul(a.b, a.a, ta=not a.tb, tb=not a.ta, tau=a.tau)
    if isinstance(a, SymMul):                   # (S B)^T = B^T S
        other = "right" if a.side == "left" else "left"
        return SymMul(a.s, _fold_transpose(a.b), other)
    return Transpose(a)


# ---------------------------------------------------------------------------
# Structural fingerprint (plan-cache key)
# ---------------------------------------------------------------------------

def fingerprint(e: Expr, structure_of, params) -> tuple[str, list]:
    """(cache key, input nids in slot order) of a rewritten expression.

    The key hashes the expression *shape* (ops, flags, per-node tau, and
    which slots coincide — ``X @ X`` is not ``X @ Y``) together with each
    distinct input's quadtree **structure** fingerprint
    (:func:`~repro_torch.core.quadtree.qt_structure_fp` via ``structure_of``)
    and the session's :class:`~repro_torch.core.quadtree.QTParams`.  Values are
    excluded: a cached :class:`~repro_torch.api.plan.Plan` re-executes for any
    inputs with matching structure via rebinding.
    """
    import hashlib

    slots: dict[Optional[int], int] = {}
    toks: list[str] = []

    def walk(x: Expr) -> None:
        if isinstance(x, Input):
            s = slots.get(x.nid)
            if s is None:
                s = slots[x.nid] = len(slots)
                toks.append(f"def{s}:{structure_of(x.nid)}:{int(x.upper)}")
            toks.append(f"in{s}")
        elif isinstance(x, Transpose):
            toks.append("T(")
            walk(x.a)
            toks.append(")")
        elif isinstance(x, Scale):
            toks.append(f"S{x.alpha!r}(")
            walk(x.a)
            toks.append(")")
        elif isinstance(x, Add):
            toks.append("+(")
            for t in x.terms:
                walk(t)
                toks.append(",")
            toks.append(")")
        elif isinstance(x, MatMul):
            toks.append(f"@[{int(x.ta)}{int(x.tb)};{x.tau!r}](")
            walk(x.a)
            toks.append(",")
            walk(x.b)
            toks.append(")")
        elif isinstance(x, SymSquare):
            toks.append("ss(")
            walk(x.a)
            toks.append(")")
        elif isinstance(x, Syrk):
            toks.append(f"rk[{int(x.trans)}](")
            walk(x.a)
            toks.append(")")
        elif isinstance(x, SymMul):
            toks.append(f"sm[{x.side}](")
            walk(x.s)
            toks.append(",")
            walk(x.b)
            toks.append(")")
        elif isinstance(x, InvChol):
            toks.append("ic(")
            walk(x.a)
            toks.append(")")
        elif isinstance(x, TriSolve):
            toks.append("ts(")
            walk(x.r)
            toks.append(",")
            walk(x.b)
            toks.append(")")
        else:
            raise TypeError(f"not an Expr: {x!r}")

    walk(e)
    toks.append(f"|p{params.n}:{params.leaf_n}:{params.bs}")
    key = hashlib.sha1("".join(toks).encode()).hexdigest()
    return key, list(slots)
