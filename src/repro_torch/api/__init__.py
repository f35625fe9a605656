"""Unified Session/Matrix facade — the public front door of the repo.

::

    from repro_torch import Session

    sess = Session(engine="torch", leaf_n=64, bs=8)
    A, B = sess.from_dense(a), sess.from_dense(b)
    C = (A @ B).T + sess.from_dense(c)
    C.to_dense()

Everything compiles to the documented internal layer (``qt_*`` task
programs over a raw ``CTGraph``) — see DESIGN.md for the mapping and
README.md for the migration table from the free-function API.
"""
from .expr import (Add, Expr, Input, MatMul, Scale, SymMul, SymSquare,
                   Syrk, Transpose)
from .matrix import Matrix
from .plan import Plan, PlanStructureError
from .session import PLACEMENT_ALIASES, Session

__all__ = ["Session", "Matrix", "Plan", "PlanStructureError",
           "PLACEMENT_ALIASES", "Expr", "Input", "Transpose", "Scale",
           "Add", "MatMul", "SymSquare", "Syrk", "SymMul"]
