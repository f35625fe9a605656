"""Quadtree matrix operation task types (paper §3.2-§3.3, Algorithms 1-2).

Implemented task types (names match the paper):

* ``multiply``      — C = op(A) op(B), op ∈ {id, transpose}  (Algorithm 1)
* ``add``           — C = A + B                               (Algorithm 2)
* ``create``        — creation from submatrix identifiers     (§3.2)
* ``transpose``     — C = Aᵀ materialised (facade fallback when a lazy
                      transpose meets an op with no op(A) slot, e.g. add)
* ``sym_square``    — C = A², A symmetric upper storage       (§3.3)
* ``syrk``          — C = A Aᵀ or AᵀA, C upper storage        (§3.3)
* ``sym_multiply``  — C = S B or B S, S symmetric upper       (§3.3)

NIL handling follows Algorithms 1-2 line 2 / fallback-execute semantics: a
task with a NIL input is never *executed* with data — here we resolve the NIL
check at registration time (equivalently: the runtime short-circuits to the
fallback), so ``count_kinds()['multiply']`` equals the paper's "number of
multiplication tasks" (eq. (1) counts both-nonzero products only).

Additions with exactly one NIL operand alias the other chunk id (Alg 2 lines
15-18: "C = A" is an identifier copy, no new chunk, no work).

Leaf-level tasks carry a batchable :class:`~repro_torch.core.engine.LeafPayload`
instead of an opaque closure and are dispatched through the graph's leaf
engine (engine.py): ``CTGraph(engine="numpy")`` executes them immediately
with the host library, ``CTGraph(engine="torch")`` defers and batches them
across the whole quadtree into fused kernel waves (§4.1 batched leaf work).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .engine import LeafPayload
from .quadtree import MatrixChunk, QTParams, _norm2
from .tasks import Alias, CTGraph, Dep


def _level_of(params: QTParams, n: int) -> int:
    return int(round(math.log2(params.n // n)))


@dataclasses.dataclass
class TruncationReport:
    """Running record of one error-controlled truncated multiply.

    ``error_bound`` is a worst-case bound on ``||C_exact - C_tau||_F``:
    every pruned product P = op(A') op(B') satisfies
    ``||P||_F <= ||A'||_F ||B'||_F < tau`` (submultiplicativity), and by
    the triangle inequality the total error of dropping a set of products
    is at most the sum of their individual bounds.  Subtree prunes (any
    quadtree level) and within-leaf block-pair prunes both contribute;
    a subtree pruned as a whole is counted once, covering all its
    descendants.  See DESIGN.md §5 for the derivation.
    """
    tau: float
    error_bound: float = 0.0        # running worst-case ||C_exact - C_tau||_F
    pruned_subtrees: int = 0        # recursive products pruned, any level
    pruned_leaf_pairs: int = 0      # block pairs pruned inside leaf tasks
    pruned_flops: float = 0.0       # leaf-pair flops avoided (2 bs^3 each)
    pruned_by_level: dict[int, int] = dataclasses.field(default_factory=dict)

    def record_subtree(self, bound: float, level: int) -> None:
        self.error_bound += bound
        self.pruned_subtrees += 1
        self.pruned_by_level[level] = self.pruned_by_level.get(level, 0) + 1

    def record_leaf_pair(self, bound: float, flops: float) -> None:
        self.error_bound += bound
        self.pruned_leaf_pairs += 1
        self.pruned_flops += flops

    def to_dict(self) -> dict:
        return {
            "tau": self.tau,
            "error_bound": self.error_bound,
            "pruned_subtrees": self.pruned_subtrees,
            "pruned_leaf_pairs": self.pruned_leaf_pairs,
            "pruned_flops": self.pruned_flops,
            "pruned_by_level": dict(self.pruned_by_level),
        }


def _register_create(g: CTGraph, n: int, cids: tuple, upper: bool,
                     level: int) -> Optional[int]:
    """Creation-from-submatrix-identifiers task (§3.2).

    Consumes chunk *identifiers* (fetch=False: no data transfer) and produces
    the small internal matrix chunk.  Returns NIL if every child is NIL.
    """
    if all(g.is_nil(c) for c in cids):
        return None

    def fn(*ids) -> MatrixChunk:
        norm = tuple(None if g.is_nil(i) else i for i in ids)
        return MatrixChunk(n, children=norm, upper=upper)

    nid = g.register_task("create", fn,
                          [Dep(c, fetch=False) for c in cids])
    g.nodes[nid].level = level
    return nid


def qt_add(g: CTGraph, params: QTParams, a: Optional[int], b: Optional[int]
           ) -> Optional[int]:
    """C = A + B (Algorithm 2). Single-NIL cases alias, both-NIL is NIL."""
    if g.is_nil(a):
        return b if not g.is_nil(b) else None
    if g.is_nil(b):
        return a

    ac: MatrixChunk = g.value_of(a)
    bc: MatrixChunk = g.value_of(b)
    assert ac.n == bc.n and ac.upper == bc.upper
    level = _level_of(params, ac.n)

    if ac.is_leaf:
        nid = g.register_task("add", None, [Dep(a), Dep(b)],
                              payload=LeafPayload("add", a=a, b=b))
        g.nodes[nid].level = level
        return nid

    def fn(av: MatrixChunk, bv: MatrixChunk):
        cids = tuple(
            qt_add(g, params, av.children[i], bv.children[i])
            for i in range(4))
        return Alias(_register_create(g, av.n, cids, av.upper, level))

    nid = g.register_task("add", fn, [Dep(a), Dep(b)])
    g.nodes[nid].level = level
    return nid


def qt_multiply(g: CTGraph, params: QTParams, a: Optional[int],
                b: Optional[int], ta: bool = False, tb: bool = False,
                tau: float = 0.0,
                trunc: Optional[TruncationReport] = None) -> Optional[int]:
    """C = op(A) op(B) (Algorithm 1 + transposed variants, §3.2).

    ``tau > 0`` enables SpAMM-style hierarchical norm truncation
    (DESIGN.md §5): at *every* recursion level the product is pruned to
    NIL when ``||A'||_F ||B'||_F < tau`` (cached subtree norms,
    :func:`~repro_torch.core.quadtree.qt_norm2`), and inside surviving leaf
    tasks block pairs are pruned by the same test on cached per-block
    norms — pruned pairs never reach the leaf engine, so they never
    enter a kernel wave.  Each prune's bound is accumulated into
    ``trunc`` (a :class:`TruncationReport`), whose ``error_bound`` is a
    worst-case bound on ``||C_exact - C_tau||_F``.  Norms are
    transpose-invariant, so ``ta``/``tb`` need no special casing.

    ``tau == 0`` is *graph-for-graph identical* to the exact multiply
    (pinned by tests/test_truncation.py): no flush, no norm reads, no
    pruning — the strict ``< tau`` test can never fire.
    """
    # root-entry span (recursive calls see subtree dimensions < params.n);
    # instrumentation only — registration is identical either way
    tr = g.tracer
    if tr.enabled and not g.is_nil(a) and g.value_of(a).n == params.n:
        n0 = len(g.nodes)
        with tr.span("qt.multiply", track="graph", n=params.n, tau=tau,
                     ta=ta, tb=tb) as sp:
            nid = _qt_multiply(g, params, a, b, ta, tb, tau, trunc)
            sp.set(tasks=len(g.nodes) - n0, nil=nid is None)
        return nid
    return _qt_multiply(g, params, a, b, ta, tb, tau, trunc)


def _qt_multiply(g: CTGraph, params: QTParams, a: Optional[int],
                 b: Optional[int], ta: bool = False, tb: bool = False,
                 tau: float = 0.0,
                 trunc: Optional[TruncationReport] = None) -> Optional[int]:
    if g.is_nil(a) or g.is_nil(b):
        return None
    ac: MatrixChunk = g.value_of(a)
    level = _level_of(params, ac.n)

    if tau > 0.0:
        if ac.n == params.n:
            # root entry: deferred waves must have filled the operands'
            # blocks before their norms mean anything.  Recursive calls
            # skip this (flushing mid-registration would fragment the
            # engine's cross-leaf batching of the product's own leaves).
            g.flush()
        bound = math.sqrt(_norm2(g, a) * _norm2(g, b))
        if bound < tau:
            if trunc is not None:
                trunc.record_subtree(bound, level)
            return None

    if ac.is_leaf:
        nid = g.register_task(
            "multiply", None, [Dep(a), Dep(b)],
            payload=LeafPayload("multiply", a=a, b=b, ta=ta, tb=tb,
                                tau=tau, trunc=trunc))
        g.nodes[nid].level = level
        return nid

    def fn(av: MatrixChunk, bv: MatrixChunk):
        def asub(m: int, k: int) -> Optional[int]:
            return av.child(k, m) if ta else av.child(m, k)

        def bsub(k: int, n: int) -> Optional[int]:
            return bv.child(n, k) if tb else bv.child(k, n)

        cids = []
        for m in (0, 1):
            for n in (0, 1):
                y1 = qt_multiply(g, params, asub(m, 0), bsub(0, n), ta, tb,
                                 tau=tau, trunc=trunc)
                y2 = qt_multiply(g, params, asub(m, 1), bsub(1, n), ta, tb,
                                 tau=tau, trunc=trunc)
                cids.append(qt_add(g, params, y1, y2))
        return Alias(_register_create(g, av.n, tuple(cids), False, level))

    nid = g.register_task("multiply", fn, [Dep(a), Dep(b)])
    g.nodes[nid].level = level
    return nid


def qt_transpose(g: CTGraph, params: QTParams, a: Optional[int]
                 ) -> Optional[int]:
    """C = Aᵀ, materialised.

    Multiplies fold op(A) into the task itself (Algorithm 1's op(A) op(B));
    this explicit task program exists for the cases with no op slot, e.g.
    adding a transposed matrix.  Internal levels are identifier shuffling
    (create-from-ids); leaf transposes are dispatched through the leaf
    engine as payloads so deferred backends order them after the waves
    that fill their inputs.  Symmetric upper-storage trees satisfy A = Aᵀ
    and return the same identifier (no task, no new chunk).
    """
    if g.is_nil(a):
        return None
    ac: MatrixChunk = g.value_of(a)
    if ac.upper:
        return a
    level = _level_of(params, ac.n)

    if ac.is_leaf:
        nid = g.register_task("transpose", None, [Dep(a)],
                              payload=LeafPayload("transpose", a=a))
        g.nodes[nid].level = level
        return nid

    def fn(av: MatrixChunk):
        c00, c01, c10, c11 = av.children
        cids = (qt_transpose(g, params, c00), qt_transpose(g, params, c10),
                qt_transpose(g, params, c01), qt_transpose(g, params, c11))
        created = _register_create(g, av.n, cids, False, level)
        if created is not None:
            if av.norm2 is not None:
                # the Frobenius norm is transpose-invariant: maintain the
                # cache instead of recomputing it on the result subtree
                g.value_of(created).norm2 = av.norm2
            if av.trace is not None:    # so is the trace
                g.value_of(created).trace = av.trace
        return Alias(created)

    nid = g.register_task("transpose", fn, [Dep(a)])
    g.nodes[nid].level = level
    return nid


def qt_scale(g: CTGraph, params: QTParams, a: Optional[int], alpha: float
             ) -> Optional[int]:
    """C = alpha * A (facade satellite: scalar algebra for SP2-style loops).

    ``alpha == 1`` is an identifier copy (no task, no new chunk) and
    ``alpha == 0`` is structurally NIL, mirroring the NIL short-circuits
    of Algorithms 1-2.  Internal levels are identifier shuffling
    (create-from-ids); leaf scaling is dispatched through the leaf engine
    so deferred backends order it after the waves filling its input.
    Storage flags (symmetric upper) are preserved.
    """
    if g.is_nil(a) or alpha == 0.0:
        return None
    if alpha == 1.0:
        return a
    ac: MatrixChunk = g.value_of(a)
    level = _level_of(params, ac.n)

    if ac.is_leaf:
        nid = g.register_task("scale", None, [Dep(a)],
                              payload=LeafPayload("scale", a=a, alpha=alpha))
        g.nodes[nid].level = level
        return nid

    def fn(av: MatrixChunk):
        cids = tuple(qt_scale(g, params, c, alpha) for c in av.children)
        created = _register_create(g, av.n, cids, av.upper, level)
        if created is not None and av.norm2 is not None:
            # ||alpha A||_F^2 = alpha^2 ||A||_F^2: maintain the cache
            g.value_of(created).norm2 = av.norm2 * alpha * alpha
        return Alias(created)

    nid = g.register_task("scale", fn, [Dep(a)])
    g.nodes[nid].level = level
    return nid


def qt_replay(g: CTGraph, nids, *, flush: bool = True) -> None:
    """Re-execute the numeric work of an already-registered task program.

    ``nids`` is the (ascending) node-id range a compiled Plan registered.
    Registration order is dependency order for leaf payload tasks (their
    operand ids always precede them), so one forward sweep re-dispatches
    every payload task through the graph's leaf engine —
    :meth:`~repro_torch.core.engine.LeafEngine.reexecute` fills the *existing*
    chunks in place, registering nothing — and a final flush runs the
    deferred backends' batched waves.  Structural nodes (creates,
    recursion containers, aliases) hold only identifiers and need no
    recomputation.

    ``flush=False`` leaves the re-dispatched work deferred so a serving
    front end can coalesce the ready waves of several plans into shared
    batched dispatches before flushing once (DESIGN.md §9).
    """
    for nid in nids:
        node = g.nodes[nid]
        if node.payload is not None and node.value is not None:
            g.engine.reexecute(g, node, node.payload)
    if flush:
        g.flush()


def qt_sym_square(g: CTGraph, params: QTParams, a: Optional[int]
                  ) -> Optional[int]:
    """C = A², A symmetric in upper-triangular storage (§3.3)."""
    if g.is_nil(a):
        return None
    ac: MatrixChunk = g.value_of(a)
    assert ac.upper
    level = _level_of(params, ac.n)

    if ac.is_leaf:
        nid = g.register_task("sym_square", None, [Dep(a)],
                              payload=LeafPayload("sym_square", a=a))
        g.nodes[nid].level = level
        return nid

    def fn(av: MatrixChunk):
        a00, a01, _, a11 = av.children
        c00 = qt_add(g, params,
                     qt_sym_square(g, params, a00),
                     qt_syrk(g, params, a01, trans=False))
        c01 = qt_add(g, params,
                     qt_sym_multiply(g, params, a00, a01, side="left"),
                     qt_sym_multiply(g, params, a11, a01, side="right"))
        c11 = qt_add(g, params,
                     qt_sym_square(g, params, a11),
                     qt_syrk(g, params, a01, trans=True))
        return Alias(_register_create(g, av.n, (c00, c01, None, c11), True,
                                      level))

    nid = g.register_task("sym_square", fn, [Dep(a)])
    g.nodes[nid].level = level
    return nid


def qt_syrk(g: CTGraph, params: QTParams, a: Optional[int],
            trans: bool = False) -> Optional[int]:
    """C = A Aᵀ (trans=False) or AᵀA (trans=True); C upper storage (§3.3)."""
    if g.is_nil(a):
        return None
    ac: MatrixChunk = g.value_of(a)
    assert not ac.upper
    level = _level_of(params, ac.n)

    if ac.is_leaf:
        nid = g.register_task("syrk", None, [Dep(a)],
                              payload=LeafPayload("syrk", a=a, trans=trans))
        g.nodes[nid].level = level
        return nid

    def fn(av: MatrixChunk):
        a00, a01, a10, a11 = av.children
        if not trans:   # C = A Aᵀ
            c00 = qt_add(g, params, qt_syrk(g, params, a00, False),
                         qt_syrk(g, params, a01, False))
            c01 = qt_add(g, params,
                         qt_multiply(g, params, a00, a10, tb=True),
                         qt_multiply(g, params, a01, a11, tb=True))
            c11 = qt_add(g, params, qt_syrk(g, params, a10, False),
                         qt_syrk(g, params, a11, False))
        else:           # C = Aᵀ A
            c00 = qt_add(g, params, qt_syrk(g, params, a00, True),
                         qt_syrk(g, params, a10, True))
            c01 = qt_add(g, params,
                         qt_multiply(g, params, a00, a01, ta=True),
                         qt_multiply(g, params, a10, a11, ta=True))
            c11 = qt_add(g, params, qt_syrk(g, params, a01, True),
                         qt_syrk(g, params, a11, True))
        return Alias(_register_create(g, av.n, (c00, c01, None, c11), True,
                                      level))

    nid = g.register_task("syrk", fn, [Dep(a)])
    g.nodes[nid].level = level
    return nid


def qt_sym_multiply(g: CTGraph, params: QTParams, s: Optional[int],
                    b: Optional[int], side: str = "left") -> Optional[int]:
    """C = S B (side='left') or C = B S (side='right'); S symmetric upper."""
    if g.is_nil(s) or g.is_nil(b):
        return None
    sc: MatrixChunk = g.value_of(s)
    bc: MatrixChunk = g.value_of(b)
    assert sc.upper and not bc.upper
    level = _level_of(params, sc.n)

    if sc.is_leaf:
        nid = g.register_task(
            "sym_multiply", None, [Dep(s), Dep(b)],
            payload=LeafPayload("sym_multiply", a=s, b=b, side=side))
        g.nodes[nid].level = level
        return nid

    def fn(sv: MatrixChunk, bv: MatrixChunk):
        s00, s01, _, s11 = sv.children
        b00, b01, b10, b11 = bv.children
        if side == "left":      # C = S B;  S10 = S01ᵀ implicit
            c00 = qt_add(g, params,
                         qt_sym_multiply(g, params, s00, b00, "left"),
                         qt_multiply(g, params, s01, b10))
            c01 = qt_add(g, params,
                         qt_sym_multiply(g, params, s00, b01, "left"),
                         qt_multiply(g, params, s01, b11))
            c10 = qt_add(g, params,
                         qt_multiply(g, params, s01, b00, ta=True),
                         qt_sym_multiply(g, params, s11, b10, "left"))
            c11 = qt_add(g, params,
                         qt_multiply(g, params, s01, b01, ta=True),
                         qt_sym_multiply(g, params, s11, b11, "left"))
        else:                    # C = B S
            c00 = qt_add(g, params,
                         qt_sym_multiply(g, params, s00, b00, "right"),
                         qt_multiply(g, params, b01, s01, tb=True))
            c01 = qt_add(g, params,
                         qt_multiply(g, params, b00, s01),
                         qt_sym_multiply(g, params, s11, b01, "right"))
            c10 = qt_add(g, params,
                         qt_sym_multiply(g, params, s00, b10, "right"),
                         qt_multiply(g, params, b11, s01, tb=True))
            c11 = qt_add(g, params,
                         qt_multiply(g, params, b10, s01),
                         qt_sym_multiply(g, params, s11, b11, "right"))
        return Alias(_register_create(g, sv.n, (c00, c01, c10, c11), False,
                                      level))

    nid = g.register_task("sym_multiply", fn, [Dep(s), Dep(b)])
    g.nodes[nid].level = level
    return nid


# ---------------------------------------------------------------------------
# Counting utilities (Figs 3-4)
# ---------------------------------------------------------------------------

MULTIPLY_KINDS = ("multiply", "sym_square", "syrk", "sym_multiply")


def count_tasks_per_level(g: CTGraph, kinds=MULTIPLY_KINDS
                          ) -> dict[int, int]:
    out: dict[int, int] = {}
    for n in g.nodes:
        if n.kind in kinds and n.level >= 0:
            out[n.level] = out.get(n.level, 0) + 1
    return out


def total_multiply_tasks(g: CTGraph) -> int:
    return sum(1 for n in g.nodes if n.kind in MULTIPLY_KINDS)


def total_add_tasks(g: CTGraph) -> int:
    return sum(1 for n in g.nodes if n.kind == "add")


def total_flops(g: CTGraph) -> float:
    return sum(n.flops for n in g.nodes)
