"""Quadtree representation of matrices in the Chunks and Tasks model (paper §3).

Matrices are sparse quadtrees of chunks: at every non-leaf level a matrix
chunk holds the chunk identifiers of its four submatrices (NIL for zero
submatrices — possible at *any* level); at the lowest level a block-sparse
:class:`~repro_torch.core.leaf.LeafMatrix` is stored.  Matrix chunks carry their own
dimension and the leaf-dimension threshold but no global information (offsets
etc.), exactly as in §3.1.

Construction itself is a task program (paper §7: "generation of input matrices
... was performed using Chunks and Tasks programs"), so in the cluster
simulation the *data distribution of the inputs follows from work stealing*,
which is what makes the communication measurements of Figs 11-13 meaningful.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .chunks import Chunk
from .leaf import LeafMatrix
from .tasks import Alias, CTGraph, Dep


@dataclasses.dataclass(frozen=True)
class QTParams(Chunk):
    """Matrix-parameters chunk type (§3.1): dims + leaf config."""
    n: int          # global matrix dimension (power-of-two multiple of leaf_n)
    leaf_n: int     # max leaf matrix dimension
    bs: int         # internal blocksize of the block-sparse leaf type

    def nbytes(self) -> int:
        return 24

    @property
    def levels(self) -> int:
        """Number of quadtree levels below the root (root = level 0)."""
        lv = 0
        n = self.n
        while n > self.leaf_n:
            n //= 2
            lv += 1
        return lv


class MatrixChunk(Chunk):
    """Basic matrix chunk (§3.1): leaf payload or 4 child chunk identifiers."""

    __slots__ = ("n", "leaf", "children", "upper", "norm2", "trace")

    def __init__(self, n: int, leaf: Optional[LeafMatrix] = None,
                 children: Optional[tuple] = None, upper: bool = False):
        self.n = n
        self.leaf = leaf
        self.children = children  # (c00, c01, c10, c11) node ids or None
        self.upper = upper
        # cached squared Frobenius norm of the *full* (symmetric-expanded)
        # submatrix this chunk roots; None until computed by qt_norm2.
        # Chunk contents are write-once (placeholder leaves are filled
        # exactly once by an engine flush), so a value computed after a
        # flush stays valid for the chunk's lifetime — until a Plan
        # rebind/replay (api/plan.py) refreshes the values in place, which
        # drops these caches through qt_invalidate_caches.  The trace
        # cache follows the same rules.
        self.norm2: Optional[float] = None
        self.trace: Optional[float] = None

    @property
    def is_leaf(self) -> bool:
        return self.leaf is not None

    def child(self, m: int, n: int) -> Optional[int]:
        """Child chunk identifier at block-row m, block-col n (0-based)."""
        return self.children[2 * m + n]

    def nbytes(self) -> int:
        if self.leaf is not None:
            return self.leaf.nbytes()
        return 64  # four identifiers + dimension info

    def content_fingerprint(self) -> Optional[bytes]:
        """Content hash for :class:`~repro_torch.core.chunks.ChunkStore` dedup.

        Leaf chunks hash their dimensions, storage flags and block bytes;
        internal chunks opt out (their children are graph-local node ids,
        so byte-equality across registrations is not meaningful).
        """
        if self.leaf is None:
            return None
        import hashlib

        lf = self.leaf
        h = hashlib.sha1()
        h.update(f"leaf:{self.n}:{lf.bs}:{int(self.upper)}:"
                 f"{np.dtype(lf.dtype).str}".encode())
        for key in sorted(lf.blocks):
            h.update(str(key).encode())
            h.update(np.ascontiguousarray(lf.blocks[key]).tobytes())
        return h.digest()

    def content_norm2(self) -> Optional[float]:
        """Squared Frobenius norm for :meth:`ChunkStore.norm2_of`.

        Leaf chunks report the full (symmetric-expanded) norm of their
        block data; internal chunks opt out — their children are
        graph-local node ids, so the norm is a property of the quadtree
        walk (:func:`qt_norm2`), not of this chunk's bytes.
        """
        if self.leaf is None:
            return None
        if not self.upper:
            return self.leaf.norm2()
        tot = 0.0
        for (i, j) in self.leaf.blocks:
            w = self.leaf.block_norm2((i, j))
            tot += w if i == j else 2 * w
        return tot


# ---------------------------------------------------------------------------
# Construction task programs
# ---------------------------------------------------------------------------

def qt_from_dense(g: CTGraph, a: np.ndarray, params: QTParams,
                  upper: bool = False, tol: float = 0.0) -> Optional[int]:
    """Register the task tree that builds the quadtree for dense ``a``.

    Returns the root chunk's node id, or None (NIL) for an all-zero matrix.
    ``upper=True`` builds symmetric upper-triangular storage: the strictly
    lower quadrant is NIL at every level and leaves use upper block storage
    (block rows i <= j kept; diagonal blocks stored full and symmetric).
    ``a`` must then be the full symmetric matrix.
    """
    assert a.shape == (params.n, params.n)

    def build(sub: np.ndarray, up: bool) -> Optional[int]:
        n = sub.shape[0]
        if not np.any(np.abs(sub) > tol):
            return None
        if n <= params.leaf_n:
            leaf = LeafMatrix.from_dense(sub, params.bs, upper=up, tol=tol)
            if leaf.is_zero():
                return None
            return g.register_task(
                "create", lambda lf=leaf, nn=n, uu=up: MatrixChunk(
                    nn, leaf=lf, upper=uu), [])

        def fn() -> MatrixChunk:
            h = n // 2
            c00 = build(sub[:h, :h], up)
            c01 = build(sub[:h, h:], False)
            c10 = None if up else build(sub[h:, :h], False)
            c11 = build(sub[h:, h:], up)
            return MatrixChunk(n, children=(c00, c01, c10, c11), upper=up)

        return g.register_task("create", fn, [])

    tr = g.tracer
    if tr.enabled:
        n0 = len(g.nodes)
        with tr.span("qt.from_dense", track="graph", n=params.n,
                     leaf_n=params.leaf_n, bs=params.bs) as sp:
            nid = build(a, upper)
            sp.set(tasks=len(g.nodes) - n0, nil=nid is None)
        return nid
    return build(a, upper)


def qt_from_coo(g: CTGraph, rows: np.ndarray, cols: np.ndarray,
                params: QTParams,
                value_fn: Optional[Callable] = None,
                upper: bool = False) -> Optional[int]:
    """Build a quadtree from nonzero coordinates without a dense matrix.

    ``value_fn(r, c) -> np.ndarray`` produces deterministic element values for
    index arrays; defaults to a hash-based pseudo-random generator so tests
    at paper-scale dimensions need no O(n^2) memory.
    """
    if value_fn is None:
        def value_fn(r, c):
            h = (r.astype(np.uint64) * np.uint64(2654435761)
                 ^ c.astype(np.uint64) * np.uint64(40503)) & np.uint64(0xFFFF)
            return (h.astype(np.float64) / 65535.0) - 0.5

    if upper:
        # keep whole upper-triangle *blocks*: diagonal leaf blocks stay full
        keep = (cols // params.bs) >= (rows // params.bs)
        rows, cols = rows[keep], cols[keep]

    def build(r: np.ndarray, c: np.ndarray, n: int, r0: int, c0: int,
              up: bool) -> Optional[int]:
        if len(r) == 0:
            return None
        if n <= params.leaf_n:
            rr, cc = r - r0, c - c0
            vals = value_fn(r, c)

            def mk(rr=rr, cc=cc, vals=vals, nn=n, uu=up) -> MatrixChunk:
                leaf = LeafMatrix(nn, params.bs, upper=uu)
                bi, bj = rr // params.bs, cc // params.bs
                order = np.lexsort((cc, rr))
                for t in order:
                    key = (int(bi[t]), int(bj[t]))
                    blk = leaf.blocks.get(key)
                    if blk is None:
                        blk = np.zeros((params.bs, params.bs))
                        leaf.blocks[key] = blk
                    blk[rr[t] % params.bs, cc[t] % params.bs] = vals[t]
                return MatrixChunk(nn, leaf=leaf, upper=uu)

            return g.register_task("create", mk, [])

        def fn() -> MatrixChunk:
            h = n // 2
            top = r < r0 + h
            left = c < c0 + h
            c00 = build(r[top & left], c[top & left], h, r0, c0, up)
            c01 = build(r[top & ~left], c[top & ~left], h, r0, c0 + h, False)
            c10 = None if up else build(r[~top & left], c[~top & left],
                                        h, r0 + h, c0, False)
            c11 = build(r[~top & ~left], c[~top & ~left], h, r0 + h, c0 + h,
                        up)
            return MatrixChunk(n, children=(c00, c01, c10, c11), upper=up)

        return g.register_task("create", fn, [])

    tr = g.tracer
    if tr.enabled:
        n0 = len(g.nodes)
        with tr.span("qt.from_coo", track="graph", n=params.n,
                     nnz=int(len(np.asarray(rows)))) as sp:
            nid = build(np.asarray(rows), np.asarray(cols), params.n,
                        0, 0, upper)
            sp.set(tasks=len(g.nodes) - n0, nil=nid is None)
        return nid
    return build(np.asarray(rows), np.asarray(cols), params.n, 0, 0, upper)


def qt_extract(g: CTGraph, params: QTParams, a: Optional[int],
               path) -> tuple[Optional[int], QTParams]:
    """Principal-submatrix extraction: descend a quadrant path (§3.1).

    ``path`` is a sequence of child indices (0..3, row-major: 0 and 3 are
    the diagonal quadrants) naming the subtree to extract; each step
    halves the dimension.  Returns ``(nid, sub_params)`` where ``nid``
    aliases the existing child chunk — chunks are immutable and carry
    their own dimension (no global offsets, §3.1), so a subtree *is* a
    complete matrix of the smaller dimension as-is, and its cached
    norm2/trace values (and those of everything below it) carry over
    untouched rather than being recomputed.

    The localized inverse-factorization solver (arXiv:1901.07993) builds
    on this: principal submatrices of the overlap matrix are factorized
    independently and refined, touching only local subtrees.
    """
    path = tuple(path)
    n = params.n
    for idx in path:
        if idx not in (0, 1, 2, 3):
            raise ValueError(f"qt_extract: bad quadrant index {idx!r}")
        if n <= params.leaf_n:
            raise ValueError(
                "qt_extract: path descends below the leaf level "
                f"(n={n}, leaf_n={params.leaf_n})")
        n //= 2
    sub_params = QTParams(n, params.leaf_n, params.bs)
    if not path:
        return a, sub_params            # identity extraction
    if g.value_of(a) is None:
        return None, sub_params         # every subtree of NIL is NIL

    def fn(_: object) -> Alias:
        nid = a
        for idx in path:
            chunk: Optional[MatrixChunk] = g.value_of(nid)
            if chunk is None:
                return Alias(None)
            assert not chunk.is_leaf, "qt_extract: hit a leaf mid-path"
            nid = chunk.children[idx]
        return Alias(nid)

    # fetch=False: extraction routes identifiers, it never reads leaf data
    out = g.register_task("extract", fn, [Dep(a, fetch=False)])
    g.nodes[out].level = len(path)
    if g.value_of(out) is None:
        return None, sub_params
    return out, sub_params


# ---------------------------------------------------------------------------
# Readback / stats (host-side; not part of the task program)
# ---------------------------------------------------------------------------

def qt_to_dense(g: CTGraph, nid: Optional[int], params: QTParams
                ) -> np.ndarray:
    """Read a quadtree matrix back to dense.

    Symmetric upper-storage trees are expanded to the full symmetric matrix
    (the lower quadrant at each level is the transpose of the stored upper
    one; upper-storage leaves expand to full symmetric leaves).
    """
    g.flush()   # deferred leaf waves must have filled block data

    def read(nid: Optional[int], n: int) -> np.ndarray:
        chunk: Optional[MatrixChunk] = g.value_of(nid)
        if chunk is None:
            return np.zeros((n, n))
        if chunk.is_leaf:
            return chunk.leaf.to_dense()  # full symmetric when upper storage
        out = np.zeros((n, n))
        h = n // 2
        out[:h, :h] = read(chunk.child(0, 0), h)
        out[:h, h:] = read(chunk.child(0, 1), h)
        out[h:, h:] = read(chunk.child(1, 1), h)
        if chunk.upper:
            out[h:, :h] = out[:h, h:].T
        else:
            out[h:, :h] = read(chunk.child(1, 0), h)
        return out

    return read(nid, params.n)


def qt_stats(g: CTGraph, nid: Optional[int]) -> dict:
    """Leaf blocks / bytes / max depth of a quadtree matrix."""
    out = {"leaf_chunks": 0, "internal_chunks": 0, "nnz_blocks": 0,
           "bytes": 0, "depth": 0}

    def walk(nid: Optional[int], depth: int) -> None:
        chunk: Optional[MatrixChunk] = g.value_of(nid)
        if chunk is None:
            return
        out["depth"] = max(out["depth"], depth)
        out["bytes"] += chunk.nbytes()
        if chunk.is_leaf:
            out["leaf_chunks"] += 1
            out["nnz_blocks"] += chunk.leaf.n_nonzero_blocks()
            return
        out["internal_chunks"] += 1
        for c in chunk.children:
            walk(c, depth + 1)

    walk(nid, 0)
    return out


def qt_frob2(g: CTGraph, nid: Optional[int]) -> float:
    """Squared Frobenius norm of a quadtree matrix (alias of qt_norm2)."""
    return qt_norm2(g, nid)


def qt_norm2(g: CTGraph, nid: Optional[int]) -> float:
    """Squared Frobenius norm, cached at every quadtree node (DESIGN.md §5).

    Flushes first so deferred leaf waves have filled their placeholder
    blocks; after a flush every registered chunk's content is final
    (block fills are write-once), so the per-node caches stay valid even
    as later task programs extend the graph with *new* chunks.
    """
    g.flush()   # deferred leaf waves must have filled block data
    return _norm2(g, nid)


def _norm2(g: CTGraph, nid: Optional[int]) -> float:
    """Non-flushing cached norm walk; callers must ensure chunk data is
    final (the truncated multiply flushes once at its root entry)."""
    chunk: Optional[MatrixChunk] = g.value_of(nid)
    if chunk is None:
        return 0.0
    if chunk.norm2 is not None:
        return chunk.norm2
    if chunk.is_leaf:
        tot = chunk.content_norm2()     # full symmetric-expanded leaf norm
    else:
        tot = 0.0
        for idx, c in enumerate(chunk.children):
            w = _norm2(g, c)
            if chunk.upper and idx == 1:  # off-diagonal counted twice
                w *= 2
            tot += w
    chunk.norm2 = tot
    return tot


def qt_trace(g: CTGraph, nid: Optional[int]) -> float:
    """Trace of a quadtree matrix, cached at every node like qt_norm2.

    Only the diagonal path (c00/c11 at every level) is walked; symmetric
    upper storage needs no special casing because the diagonal quadrants
    are stored and diagonal leaf blocks are kept full.
    """
    g.flush()   # deferred leaf waves must have filled block data
    return _trace(g, nid)


def _trace(g: CTGraph, nid: Optional[int]) -> float:
    chunk: Optional[MatrixChunk] = g.value_of(nid)
    if chunk is None:
        return 0.0
    if chunk.trace is not None:
        return chunk.trace
    if chunk.is_leaf:
        tot = chunk.leaf.trace()
    else:
        tot = _trace(g, chunk.child(0, 0)) + _trace(g, chunk.child(1, 1))
    chunk.trace = tot
    return tot


# ---------------------------------------------------------------------------
# Input rebinding (compiled-Plan re-execution, api/plan.py)
#
# A Plan replays a fixed task program against *refreshed input values*: the
# quadtree structure — NIL pattern, leaf block occupancy — is part of the
# plan's fingerprint and must not change, so rebinding is an in-place fill
# of the existing leaf blocks plus cache invalidation.  No tasks are
# registered and no chunks are created.  Structure mismatches raise
# :class:`PlanStructureError` *before any block is mutated* (validate
# pass, then fill pass), so a failed rebind leaves the compiled input —
# and therefore the plan — fully usable; ``plan.run(..., recompile=True)``
# relies on this atomicity to fall back to a fresh compile.
# ---------------------------------------------------------------------------

class PlanStructureError(ValueError):
    """A rebound plan input's sparsity structure differs from the structure
    frozen into the compiled fingerprint.

    A compiled :class:`~repro_torch.api.plan.Plan` replays a *fixed* task
    program — including truncation pair lists frozen at compile time — so
    values that fall outside the compiled structure (a denser iterate in
    a purification loop, a different NIL pattern) cannot be replayed:
    the stale program would silently drop their contributions.  Either
    build a fresh matrix and plan for the new structure, or pass
    ``recompile=True`` to :meth:`~repro_torch.api.plan.Plan.run` to recompile
    through the session's plan cache transparently.  Subclasses
    ``ValueError`` for backwards compatibility with callers that caught
    the untyped error this used to be.
    """


def _subtree_leaf_ids(g: CTGraph, nid: Optional[int]) -> set:
    """``id(LeafMatrix)`` of every leaf under ``nid`` (NIL-aware)."""
    ids: set = set()

    def walk(n: Optional[int]) -> None:
        chunk: Optional[MatrixChunk] = g.value_of(n)
        if chunk is None:
            return
        if chunk.is_leaf:
            ids.add(id(chunk.leaf))
        else:
            for c in chunk.children:
                walk(c)

    walk(nid)
    return ids


def _flush_if_entangled(g: CTGraph, leaf_ids: set) -> None:
    """Flush only when deferred work touches one of these leaves.

    Rebind overwrites leaf payloads in place, so any pending task reading
    or writing them must run first.  But an *unconditional* flush here
    would drain every other in-flight plan's deferred waves as a side
    effect, defeating the serving layer's cross-plan wave coalescing
    (DESIGN.md §9) — so unrelated pending work is left untouched.
    """
    eng = g._engine
    if eng is not None and eng.has_pending_for(leaf_ids):
        g.flush()


def qt_rebind_dense(g: CTGraph, nid: Optional[int], a: np.ndarray,
                    params: QTParams) -> None:
    """Refill a built quadtree's leaf values from a dense array, in place.

    ``a`` must be supported on the tree's existing structure: any entry
    outside a stored leaf block (or inside a NIL subtree) must be zero —
    structure changes raise :class:`PlanStructureError` before anything
    is written (a fresh matrix and plan, or ``Plan.run(recompile=True)``,
    handle a different sparsity structure).  For symmetric upper storage
    pass the full symmetric matrix, exactly as :func:`qt_from_dense`
    expects.
    """
    a = np.asarray(a)
    assert a.shape == (params.n, params.n)
    # placeholder leaves must be final before we overwrite them
    _flush_if_entangled(g, _subtree_leaf_ids(g, nid))

    def check(nid: Optional[int], sub: np.ndarray) -> None:
        chunk: Optional[MatrixChunk] = g.value_of(nid)
        if chunk is None:
            if np.any(sub != 0.0):
                raise PlanStructureError(
                    "rebind structure mismatch: new values are nonzero "
                    "inside a NIL subtree of the compiled input; build a "
                    "new matrix (and plan) for a different sparsity "
                    "structure, or run the plan with recompile=True")
            return
        if chunk.is_leaf:
            lf = chunk.leaf
            bs = lf.bs
            grid = lf.n // bs
            for bi in range(grid):
                bj0 = bi if lf.upper else 0
                for bj in range(bj0, grid):
                    if (bi, bj) in lf.blocks:
                        continue
                    blk = sub[bi * bs:(bi + 1) * bs, bj * bs:(bj + 1) * bs]
                    if np.any(blk != 0.0):
                        raise PlanStructureError(
                            "rebind structure mismatch: new values fall "
                            "outside the compiled input's leaf block "
                            "structure; build a new matrix (and plan), "
                            "or run the plan with recompile=True")
        else:
            h = chunk.n // 2
            check(chunk.child(0, 0), sub[:h, :h])
            check(chunk.child(0, 1), sub[:h, h:])
            if not chunk.upper:
                check(chunk.child(1, 0), sub[h:, :h])
            check(chunk.child(1, 1), sub[h:, h:])

    def fill(nid: Optional[int], sub: np.ndarray) -> None:
        chunk: Optional[MatrixChunk] = g.value_of(nid)
        if chunk is None:
            return
        if chunk.is_leaf:
            lf = chunk.leaf
            bs = lf.bs
            for (i, j), blk in lf.blocks.items():
                blk[...] = sub[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs]
            lf.invalidate_norms()
        else:
            h = chunk.n // 2
            fill(chunk.child(0, 0), sub[:h, :h])
            fill(chunk.child(0, 1), sub[:h, h:])
            if not chunk.upper:
                fill(chunk.child(1, 0), sub[h:, :h])
            fill(chunk.child(1, 1), sub[h:, h:])
        chunk.norm2 = None
        chunk.trace = None

    check(nid, a)   # atomic: raise before the first block is written
    fill(nid, a)


def qt_rebind_from(g: CTGraph, dst: Optional[int], src: Optional[int]
                   ) -> None:
    """Copy leaf values from one quadtree into a structure-identical other.

    This is the iterative-algorithm hot path: feeding a plan's output back
    into its input slot copies the values *before* the replay starts, so
    rebinding an input to the plan's own previous output is safe.  Raises
    :class:`PlanStructureError` on any structural difference (NIL
    pattern, leaf keys) — before any destination block is written, so the
    compiled input survives a failed rebind untouched.
    """
    # src leaves are read, dst leaves overwritten: both must be settled
    _flush_if_entangled(g, _subtree_leaf_ids(g, dst)
                        | _subtree_leaf_ids(g, src))

    def check(d: Optional[int], s: Optional[int]) -> None:
        dc: Optional[MatrixChunk] = g.value_of(d)
        sc: Optional[MatrixChunk] = g.value_of(s)
        if (dc is None) != (sc is None):
            raise PlanStructureError(
                "rebind structure mismatch: NIL pattern differs between "
                "the compiled input and the new operand; build a new "
                "plan, or run the existing one with recompile=True")
        if dc is None:
            return
        if dc.is_leaf != sc.is_leaf or dc.n != sc.n:
            raise PlanStructureError(
                "rebind structure mismatch: quadtree shapes differ")
        if dc.is_leaf:
            if set(dc.leaf.blocks) != set(sc.leaf.blocks):
                raise PlanStructureError(
                    "rebind structure mismatch: leaf block occupancy "
                    "differs between the compiled input and the new "
                    "operand; build a new plan, or run the existing one "
                    "with recompile=True")
        else:
            for i in range(4):
                check(dc.children[i], sc.children[i])

    def copy(d: Optional[int], s: Optional[int]) -> None:
        dc: Optional[MatrixChunk] = g.value_of(d)
        sc: Optional[MatrixChunk] = g.value_of(s)
        if dc is None:
            return
        if dc.is_leaf:
            for key, blk in sc.leaf.blocks.items():
                dc.leaf.blocks[key][...] = blk
            dc.leaf.invalidate_norms()
        else:
            for i in range(4):
                copy(dc.children[i], sc.children[i])
        dc.norm2 = None
        dc.trace = None

    check(dst, src)   # atomic: raise before the first block is written
    copy(dst, src)


def qt_invalidate_caches(g: CTGraph, nids) -> None:
    """Drop chunk-level norm/trace caches of the given nodes' chunks.

    Plan replay refreshes chunk values in place; every cache computed from
    the old values (chunk norms used by SpAMM pruning, traces) must go.
    Leaf-level caches are dropped by the engines' in-place fills; this
    covers the chunk objects themselves, including internal create-level
    chunks whose norms aggregate their subtrees.
    """
    for nid in nids:
        chunk = g.nodes[nid].value
        if isinstance(chunk, MatrixChunk):
            chunk.norm2 = None
            chunk.trace = None
            if chunk.leaf is not None:
                chunk.leaf.invalidate_norms()


def qt_structure_fp(g: CTGraph, nid: Optional[int]) -> str:
    """Structural fingerprint of a quadtree: NIL pattern + leaf occupancy.

    Values are deliberately excluded — two matrices with the same
    structure fingerprint are interchangeable as compiled-plan inputs
    (same task program, same chunk shapes), differing only in the numbers
    a rebind fills in.  Structure is final at registration (deferred
    engines allocate placeholder blocks up front), so no flush is needed.
    """
    import hashlib

    h = hashlib.sha1()

    def walk(nid: Optional[int]) -> None:
        chunk: Optional[MatrixChunk] = g.value_of(nid)
        if chunk is None:
            h.update(b"N")
            return
        if chunk.is_leaf:
            h.update(f"L{chunk.n}:{chunk.leaf.bs}:{int(chunk.upper)}:"
                     f"{sorted(chunk.leaf.blocks)}".encode())
            return
        h.update(f"I{chunk.n}:{int(chunk.upper)}(".encode())
        for c in chunk.children:
            walk(c)
        h.update(b")")

    walk(nid)
    return h.hexdigest()


_ = Dep  # re-export convenience for callers building custom task programs
