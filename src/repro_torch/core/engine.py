"""Leaf execution engine: pluggable backends for leaf-level multiply work.

The paper's performance story (§4.1) is that leaf-level multiplication work
is *batched* and offloaded: "in case GPUs are available, both CPUs and GPUs
are used for leaf-level multiplication work", with the small block GEMMs
mapped onto the cuBLAS batched-gemm API.  This module is the port's
rendering of that pluggable leaf engine:

* :class:`NumpyEngine` — the reference backend; executes each leaf task
  immediately with the host library (core/leaf.py), preserving the original
  per-task semantics exactly.
* :class:`TorchEngine` — the GPU backend.  Leaf multiply/syrk/
  sym_square/sym_multiply tasks are *not* executed at registration: their
  output **structure** is computed up front (the same occupancy
  :func:`repro_torch.core.bsmm.compute_c_structure` gives on the leaf
  masks) and zero placeholder blocks are allocated, while the numeric
  work is deferred.  At flush the ready leaf tasks of the whole quadtree
  form one wave: :func:`number_wave`, the wave planner of every executor
  (the mesh's ``launch.mesh_exec.plan_wave`` included), numbers its pairs,
  operand blocks and C slots, and :func:`gather_wave` packs them for **one
  kernel launch** — the CUDA ``kernels.bsmm_pairs`` (gather-GEMM-scatter)
  or ``kernels.batched_gemm`` and an on-device scatter-add: the paper's
  Fig 2 outer-product batching, lifted from per-leaf to per-graph.

Correctness of deferral rests on a structural fact both backends share: the
*occupancy* of every leaf result is determined by the operand masks alone
(einsum over structurally-present pairs), so NIL propagation — and therefore
the task graph, task counts and flop attribution — is identical across
backends; only the numeric fill is deferred.  Numerically the backends agree
to float32 precision: the torch backend packs operands as float32 and its
kernels accumulate in float32, so its result leaves are float32 even when
the inputs are float64 (see the TorchEngine docstring).

Flop/byte attribution: each task's ``node.flops`` is set at registration
from its structural pair count (identical formula to the numpy backend's
LeafStats), so the runtime simulator sees per-task work regardless of
backend; the fused-wave reality (kernel wall time, pair and padding
counts, bytes packed) is recorded in :meth:`TorchEngine.stats`.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any, Optional

import numpy as np
import torch

from .leaf import (LeafMatrix, LeafStats, alloc_structure, inv_chol_keys,
                   leaf_add, leaf_inv_chol, leaf_multiply, leaf_scale,
                   leaf_sym_multiply, leaf_sym_square, leaf_syrk,
                   leaf_tri_solve, tri_solve_keys, unpack_blocks)
from .quadtree import MatrixChunk
from repro_torch.obs.tracer import NOOP

#: leaf-payload kinds executed host-side (no kernel wave)
HOST_KINDS = ("add", "transpose", "scale")

#: the reference's batched_gemm batch tile (the CUDA kernel does not pad)
GEMM_BATCH_TILE = 8

#: leaf-payload kinds dispatched through the batched triangular kernels
#: (kernels/tri.py) — their own wave family, never mixed into GEMM waves
SOLVE_KINDS = ("tri_solve", "inv_chol")


@dataclasses.dataclass(frozen=True)
class LeafPayload:
    """Batchable description of a leaf task (replaces opaque closures).

    ``a``/``b`` are producer *node ids* in the registering CTGraph; the
    engine resolves them to chunks at execution time.  Only the fields
    relevant to ``kind`` are meaningful.
    """
    # multiply|sym_square|syrk|sym_multiply|add|transpose|scale
    # |tri_solve|inv_chol
    kind: str
    a: Optional[int] = None
    b: Optional[int] = None
    ta: bool = False                # multiply: transpose A
    tb: bool = False                # multiply: transpose B
    trans: bool = False             # syrk: A^T A instead of A A^T
    side: str = "left"              # sym_multiply: S B vs B S
    tau: float = 0.0                # multiply: SpAMM block-pair threshold
    alpha: float = 1.0              # scale: C = alpha * A
    # TruncationReport accumulating pruned-pair bounds; excluded from
    # eq/hash (it is an accumulator identity, not part of the task's value)
    trunc: Any = dataclasses.field(default=None, compare=False)


class EngineRebindError(RuntimeError, ValueError):
    """A stateful engine instance was bound to a second CTGraph.

    Deferred waves and flop/bytes stats are per-graph state: silently
    rebinding would flush foreign work as a side effect and conflate the
    reports.  Subclasses ValueError for backwards compatibility with code
    that caught the original exception type.
    """


class LeafEngine:
    """Backend interface consumed by :class:`~repro_torch.core.tasks.CTGraph`."""

    name = "abstract"
    #: observability hook; stateful backends resolve the bound graph's
    #: tracer instead (see TorchEngine.tracer)
    tracer = NOOP

    def execute(self, g, node, payload: LeafPayload) -> Optional[MatrixChunk]:
        """Execute (or defer) one leaf task; returns its chunk or None=NIL."""
        raise NotImplementedError

    def reexecute(self, g, node, payload: LeafPayload) -> None:
        """Recompute an already-executed leaf task's numbers *in place*.

        Compiled-Plan replay (api/plan.py): the task's output chunk
        already exists with its final block structure; only the numbers
        are refreshed from the (rebound) operand chunks.  Must register
        no tasks and allocate no chunks.  Truncated multiplies replay the
        block-pair list frozen on ``node.replay`` at first execution so
        the program — not the norms of the new values — decides the
        structure.
        """
        raise NotImplementedError

    def flush(self, g) -> None:
        """Run all deferred work; afterwards every chunk holds real numbers."""

    def free_chunks(self, g, nids) -> None:
        """Drop engine-side state tied to these chunks (Session.free).

        Stateless backends keep nothing per chunk; a backend that keeps
        device-resident block buffers overrides this to release them.
        """

    def has_pending_for(self, leaf_ids) -> bool:
        """Whether any deferred task reads or writes one of these leaves.

        ``leaf_ids`` is a set of ``id(LeafMatrix)`` values.  Immediate
        backends keep nothing deferred; the batched backends override
        this so callers that overwrite leaf values in place (the plan
        rebind hooks) can flush *only when their target is actually
        entangled with pending work* — leaving unrelated deferred waves
        intact for cross-plan coalescing (DESIGN.md §9).
        """
        return False

    def stats(self) -> dict:
        return {}


def make_engine(spec: Any) -> LeafEngine:
    """Resolve an engine spec: None/'torch' (the card), 'numpy', 'mesh'
    (the rank-sharded executor on the card), or an instance."""
    if spec is None or spec == "torch":
        return TorchEngine()
    if spec == "numpy":
        return NumpyEngine()
    if spec == "mesh":
        # lazy import: launch.mesh_exec builds on this module
        from repro_torch.launch.mesh_exec import MeshEngine
        return MeshEngine()
    if isinstance(spec, LeafEngine):
        return spec
    raise ValueError(f"unknown leaf engine spec: {spec!r}")


# ---------------------------------------------------------------------------
# Structure enumeration shared by both backends' bookkeeping
# ---------------------------------------------------------------------------

def _plain_items(leaf: LeafMatrix, trans: bool):
    """(row, col, stored_key, transpose_flag) of op(A), op in {id, T}."""
    for (i, j) in leaf.blocks:
        if trans:
            yield j, i, (i, j), True
        else:
            yield i, j, (i, j), False


def _full_items(leaf: LeafMatrix):
    """Full symmetric structure view of an upper-storage leaf."""
    for (i, j) in leaf.blocks:
        yield i, j, (i, j), False
        if i != j:
            yield j, i, (i, j), True


def operand_views(payload: LeafPayload) -> tuple:
    """``((src, view), (src, view), upper)`` of a multiply-kind task: the
    leaf (src 'a' or 'b') each operand of its block products reads, in
    which view — op(leaf) is the leaf ('plain'), its transpose ('T') or
    the full symmetric matrix of an upper-storage leaf ('full') — and
    whether C is kept in upper storage (lower-triangle products
    skipped)."""
    k = payload.kind
    if k == "multiply":
        return (("a", "T" if payload.ta else "plain"),
                ("b", "T" if payload.tb else "plain"), False)
    if k == "sym_square":
        return ("a", "full"), ("a", "full"), True
    if k == "syrk":                     # A^T A, or A A^T
        t = ("T", "plain") if payload.trans else ("plain", "T")
        return ("a", t[0]), ("a", t[1]), True
    if k == "sym_multiply":             # S B, or B S
        if payload.side == "left":
            return ("a", "full"), ("b", "plain"), False
        return ("b", "plain"), ("a", "full"), False
    raise ValueError(f"not a multiply-kind payload: {k}")


def truncates(payload: LeafPayload) -> bool:
    """Whether the task drops block pairs by their norms: a multiply with
    tau > 0 (the symmetric kinds take no tau)."""
    return payload.tau > 0.0 and payload.kind == "multiply"


def leaf_task_pairs(payload: LeafPayload, a_leaf: LeafMatrix,
                    b_leaf: Optional[LeafMatrix], tracer=NOOP):
    """All surviving block GEMMs of one leaf task, one tuple a pair: the
    host reference enumerator (the numpy backend's truncated path and
    ``validate_structure``; the torch backend builds its pairs as columns,
    :func:`number_wave`).

    Returns ``(pairs, upper)`` where each pair is
    ``(src_a, key_a, trans_a, src_b, key_b, trans_b, out_key)`` with src in
    {'a', 'b'} naming which operand leaf the stored block comes from.  The
    pair count equals the numpy backend's LeafStats.block_multiplies.

    A recording ``tracer`` counts a truncated multiply's norm test: the
    pairs it drops (``trunc.pairs_pruned``) and its seconds on
    :meth:`~repro_torch.obs.tracer.Tracer.clock`, from the first norm
    lookup to the kept list (``trunc.test_s``).
    """
    (src_a, view_a), (src_b, view_b), upper = operand_views(payload)
    srcs = {"a": a_leaf, "b": b_leaf}

    def items(src, view):
        leaf = srcs[src]
        assert leaf.upper == (view == "full")   # host-library contract
        return _full_items(leaf) if view == "full" \
            else _plain_items(leaf, view == "T")

    cols: dict[int, list] = {}
    for i, kk, key, tr in items(src_a, view_a):
        cols.setdefault(kk, []).append((i, src_a, key, tr))
    rows: dict[int, list] = {}
    for kk, j, key, tr in items(src_b, view_b):
        rows.setdefault(kk, []).append((j, src_b, key, tr))

    pairs = []
    for kk in cols.keys() & rows.keys():
        for i, sa, ka, tra in cols[kk]:
            for j, sb, kb, trb in rows[kk]:
                if upper and i > j:
                    continue        # lower triangle skipped: symmetry saving
                pairs.append((sa, ka, tra, sb, kb, trb, (i, j)))

    if truncates(payload):
        # SpAMM pruning inside the leaf (DESIGN.md §5): a block pair whose
        # norm product is below tau is dropped *structurally* — both
        # backends take their structure from the kept pairs, so pruned
        # pairs never enter a kernel wave and never touch the host library.
        # Block norms are transpose-invariant: the stored key's cached
        # norm is valid for either orientation.
        flops_each = 2.0 * a_leaf.bs ** 3
        t0 = tracer.clock() if tracer.enabled else 0.0
        kept = []
        for pr in pairs:
            sa, ka, _, sb, kb, _, _ = pr[:7]
            bound = math.sqrt(srcs[sa].block_norm2(ka)
                              * srcs[sb].block_norm2(kb))
            if bound < payload.tau:
                if payload.trunc is not None:
                    payload.trunc.record_leaf_pair(bound, flops_each)
            else:
                kept.append(pr)
        if tracer.enabled:
            tracer.add("trunc.test_s", tracer.clock() - t0)
            tracer.add("trunc.pairs_pruned", len(pairs) - len(kept))
        pairs = kept
    return pairs, upper


# ---------------------------------------------------------------------------
# The same structure as integer columns (the torch backend)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafView:
    """One view of a leaf's blocks (see :func:`operand_views`) as integer
    columns.  ``mask`` is op(leaf)'s 0/1 block mask in float32.
    ``first`` holds its blocks as a product's first operand, ``(k, i,
    code, pos)`` of block ``(i, k)`` sorted by ``(k, i)``, and ``second``
    as the second operand, ``(k, j, code, pos)`` of block ``(k, j)``
    sorted by ``(k, j)``: ``code`` is ``(si * grid + sj) * 2 +
    transpose`` of the stored block ``(si, sj)`` read and ``pos`` its
    place in the leaf's ``blocks``."""
    mask: np.ndarray
    first: tuple
    second: tuple


def _cache(leaf: LeafMatrix) -> dict:
    """The leaf's structure cache, started again if blocks were added or
    removed since it was filled (values change in place, never keys)."""
    c = leaf._views
    if c is None or c[0] != len(leaf.blocks):
        c = leaf._views = (len(leaf.blocks), {})
    return c[1]


def leaf_keys(leaf: LeafMatrix) -> np.ndarray:
    """The leaf's stored keys coded ``i * grid + j``, in ``blocks`` order
    (cached)."""
    cache = _cache(leaf)
    kc = cache.get("keys")
    if kc is None:
        ij = np.fromiter(itertools.chain.from_iterable(leaf.blocks),
                         np.int64, count=2 * len(leaf.blocks))
        kc = cache["keys"] = ij[0::2] * leaf.grid + ij[1::2]
    return kc


def leaf_view(leaf: LeafMatrix, view: str) -> LeafView:
    """The leaf's :class:`LeafView` ``view`` (cached)."""
    assert leaf.upper == (view == "full")   # host-library contract
    cache = _cache(leaf)
    v = cache.get(view)
    if v is not None:
        return v
    kc = leaf_keys(leaf)
    si, sj = np.divmod(kc, leaf.grid)
    pos = np.arange(len(kc))
    tr = np.zeros(len(kc), np.int64)
    if view == "T":
        i, j, tr = sj, si, tr + 1
    elif view == "full":
        off = pos[si != sj]
        i = np.concatenate([si, sj[off]])
        j = np.concatenate([sj, si[off]])
        pos = np.concatenate([pos, off])
        tr = np.concatenate([tr, np.ones(len(off), np.int64)])
    else:
        i, j = si, sj
    code = kc[pos] * 2 + tr
    mask = np.zeros((leaf.grid, leaf.grid), np.float32)
    mask[i, j] = 1
    by_col, by_row = np.lexsort((i, j)), np.lexsort((j, i))
    v = cache[view] = LeafView(
        mask, tuple(x[by_col] for x in (j, i, code, pos)),
        tuple(x[by_row] for x in (i, j, code, pos)))
    return v


def task_views(payload: LeafPayload, a_leaf: LeafMatrix,
               b_leaf: Optional[LeafMatrix]) -> tuple:
    """``((leaf, LeafView), (leaf, LeafView), upper)`` of a multiply-kind
    task's two operands (:func:`operand_views`)."""
    srcs = {"a": a_leaf, "b": b_leaf}
    first, second, upper = operand_views(payload)
    return tuple((srcs[s], leaf_view(srcs[s], v))
                 for s, v in (first, second)) + (upper,)


def c_structure(first: LeafView, second: LeafView, upper: bool) -> tuple:
    """``(keys, pairs)``: C's keys in row-major order and the task's pair
    count, from the product of the operands' 0/1 masks (each C cell's
    pair count; the upper triangle only where C is kept upper)."""
    counts = first.mask @ second.mask
    if upper:
        counts = np.triu(counts)
    rows, cols = np.nonzero(counts)
    return (list(zip(rows.tolist(), cols.tolist())),
            int(counts.sum(dtype=np.float64)))


def join_items(ga: np.ndarray, gb: np.ndarray, n_groups: int) -> tuple:
    """Row pairs ``(ra, rb)`` of two item lists whose group numbers agree,
    each list sorted by group: ``ra`` ascending and, for each ``ra``,
    ``rb`` ascending."""
    cnt = np.bincount(gb, minlength=n_groups)
    reps = cnt[ga]
    ra = np.repeat(np.arange(len(ga)), reps)
    first = np.cumsum(reps) - reps          # each a-row's first pair
    rb = np.arange(len(ra)) - np.repeat(
        first - (np.cumsum(cnt) - cnt)[ga], reps)
    return ra, rb


def kept_pairs(payload: LeafPayload, a_leaf: LeafMatrix,
               b_leaf: LeafMatrix, tracer=NOOP) -> np.ndarray:
    """A truncated multiply's kept block pairs as int64 columns ``(3,
    P)``: C cell ``i * grid + j`` and the two operand codes (a side from
    ``a_leaf``, b side from ``b_leaf``; :class:`LeafView`), in ascending
    ``(k, i, j)``.  A pair is kept iff ``sqrt(|A_ik|^2 |B_kj|^2) >= tau``,
    the float64 arithmetic of :func:`leaf_task_pairs`; the pruned pairs
    go to ``payload.trunc`` and the tracer's ``trunc.*`` counters as
    there, ``payload.trunc`` in that function's order of pairs, so that
    its ``error_bound`` sums to the same bits."""
    (la, fa), (lb, fb), _ = task_views(payload, a_leaf, b_leaf)
    ka, i, ca, pa = fa.first
    kb, j, cb, pb = fb.second
    ra, rb = join_items(ka, kb, a_leaf.grid)
    t0 = tracer.clock() if tracer.enabled else 0.0
    bound = np.sqrt(la.block_norm2s()[pa[ra]] * lb.block_norm2s()[pb[rb]])
    keep = bound >= payload.tau
    if payload.trunc is not None:
        # leaf_task_pairs' order: k as its set of shared k iterates (the
        # set of each side's k by first block, in ``blocks`` order), then
        # each side's blocks in ``blocks`` order (a plain or transposed
        # view has one item a block)
        ks = []
        for k, p in ((ka, pa), (kb, pb)):
            by_block = np.empty_like(k)
            by_block[p] = k
            ks.append(dict.fromkeys(by_block.tolist()).keys())
        shared = ks[0] & ks[1]
        rank = np.zeros(a_leaf.grid, np.int64)
        rank[list(shared)] = np.arange(len(shared))
        drop = ~keep
        order = np.lexsort((pb[rb[drop]], pa[ra[drop]], rank[ka[ra[drop]]]))
        payload.trunc.record_leaf_pairs(bound[drop][order],
                                        2.0 * a_leaf.bs ** 3)
    ra, rb = ra[keep], rb[keep]
    if tracer.enabled:
        tracer.add("trunc.test_s", tracer.clock() - t0)
        tracer.add("trunc.pairs_pruned", len(keep) - len(ra))
    return np.stack((i[ra] * a_leaf.grid + j[rb], ca[ra], cb[rb]))


# ---------------------------------------------------------------------------
# Reference backend
# ---------------------------------------------------------------------------

def execute_pairs_host(a_leaf: LeafMatrix, b_leaf: Optional[LeafMatrix],
                       pairs: list, upper: bool,
                       stats: Optional[LeafStats] = None) -> LeafMatrix:
    """Evaluate a leaf task from its (possibly pruned) block-pair list.

    This is the host-side twin of the kernel wave: the structure comes
    from :func:`leaf_task_pairs`, so a truncated multiply produces the
    same block occupancy on both backends by construction.
    """
    dtype = a_leaf.dtype if b_leaf is None \
        else np.result_type(a_leaf.dtype, b_leaf.dtype)
    out = LeafMatrix(a_leaf.n, a_leaf.bs, upper=upper, dtype=dtype)
    srcs = {"a": a_leaf, "b": b_leaf}
    for sa, ka, tra, sb, kb, trb, out_key in pairs:
        ab = srcs[sa].blocks[ka]
        bb = srcs[sb].blocks[kb]
        prod = (ab.T if tra else ab) @ (bb.T if trb else bb)
        cur = out.blocks.get(out_key)
        if cur is None:
            out.blocks[out_key] = prod
        else:
            cur += prod
    if stats is not None:
        stats.block_multiplies += len(pairs)
        stats.flops += 2.0 * len(pairs) * a_leaf.bs ** 3
        stats.batches += 1 if pairs else 0
    return out


class NumpyEngine(LeafEngine):
    """Immediate per-task execution with the host leaf library (§4.1)."""

    name = "numpy"

    def _compute(self, g, node, payload: LeafPayload,
                 av: MatrixChunk, bv: Optional[MatrixChunk], st: LeafStats
                 ) -> tuple[LeafMatrix, bool]:
        """The numeric work of one leaf task; shared by execute/reexecute."""
        k = payload.kind
        if truncates(payload):
            # truncated path: structure (incl. SpAMM pair pruning) comes
            # from leaf_task_pairs — identical to the torch backend's —
            # and the surviving pairs are evaluated with the host library.
            # The pair list is frozen on the node so a Plan replay re-runs
            # the same program instead of re-pruning against new norms.
            if node.replay is None:
                node.replay = leaf_task_pairs(payload, av.leaf, bv.leaf,
                                              g.tracer)
            pairs, upper = node.replay
            res = execute_pairs_host(av.leaf, bv.leaf, pairs, upper, st)
        elif k == "multiply":
            res = leaf_multiply(av.leaf, bv.leaf, ta=payload.ta,
                                tb=payload.tb, stats=st)
            upper = False
        elif k == "sym_square":
            res = leaf_sym_square(av.leaf, stats=st)
            upper = True
        elif k == "syrk":
            res = leaf_syrk(av.leaf, trans=payload.trans, stats=st)
            upper = True
        elif k == "sym_multiply":
            res = leaf_sym_multiply(av.leaf, bv.leaf, side=payload.side,
                                    stats=st)
            upper = False
        elif k == "add":
            res = leaf_add(av.leaf, bv.leaf)
            upper = av.upper
        elif k == "transpose":
            res = av.leaf.transpose()
            upper = False
        elif k == "scale":
            res = leaf_scale(av.leaf, payload.alpha)
            upper = av.upper
        elif k == "inv_chol":
            res = leaf_inv_chol(av.leaf, stats=st)
            upper = False
        elif k == "tri_solve":
            res = leaf_tri_solve(av.leaf, bv.leaf, stats=st)
            upper = False
        else:
            raise ValueError(f"unknown leaf payload kind: {k}")
        return res, upper

    def execute(self, g, node, payload: LeafPayload) -> Optional[MatrixChunk]:
        av: MatrixChunk = g.value_of(payload.a)
        bv: Optional[MatrixChunk] = (
            g.value_of(payload.b) if payload.b is not None else None)
        st = LeafStats()
        res, upper = self._compute(g, node, payload, av, bv, st)
        node.flops = st.flops
        # multiply kinds prune structurally-empty results to NIL; adds of
        # two non-NIL leaves always produce a chunk (Alg 2 semantics) —
        # matching the torch backend's structural behavior exactly.
        # Solve kinds always produce a chunk: their structure is the
        # deterministic inv_chol_keys/tri_solve_keys set, never empty.
        if payload.kind not in HOST_KINDS \
                and payload.kind not in SOLVE_KINDS and res.is_zero():
            return None
        return MatrixChunk(av.n, leaf=res, upper=upper)

    def reexecute(self, g, node, payload: LeafPayload) -> None:
        av: MatrixChunk = g.value_of(payload.a)
        bv: Optional[MatrixChunk] = (
            g.value_of(payload.b) if payload.b is not None else None)
        res, _ = self._compute(g, node, payload, av, bv, LeafStats())
        out: MatrixChunk = g.value_of(node.nid)
        dst = out.leaf
        if set(res.blocks) != set(dst.blocks):   # pragma: no cover - guard
            raise RuntimeError(
                "replay structure drift: leaf block occupancy changed "
                "between plan compilation and replay")
        for key, blk in res.blocks.items():
            dst.blocks[key][...] = blk
        dst.invalidate_norms()
        out.norm2 = None
        out.trace = None


# ---------------------------------------------------------------------------
# Batched accelerator backend
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Pending:
    nid: int
    payload: LeafPayload
    out: LeafMatrix
    a_leaf: LeafMatrix
    b_leaf: Optional[LeafMatrix]
    n_pairs: int = 0                # multiply kinds: block pairs
    # a truncated multiply's kept pairs (kept_pairs' columns); the other
    # tasks' pairs are joined at flush (number_wave)
    kept: Optional[np.ndarray] = None


def resolve_device(device=None) -> torch.device:
    """The device of an entry point of the port (``TorchEngine``, the LM):
    ``None`` means CUDA, which must be present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs its kernels on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions instead")
        device = "cuda"
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {device}")
    return device


class TorchEngine(LeafEngine):
    """Deferred, cross-leaf-batched execution through the CUDA kernels.

    Precision contract: operands are packed float32 and the kernels
    accumulate in float32, so engine-produced leaves are float32
    regardless of input dtype — expect ~1e-7 relative agreement with the
    float64 numpy backend, not bitwise equality.

    kernel   : 'pairs' -> one fused kernels.bsmm_pairs gather-GEMM-scatter
               launch per wave; 'gemm' -> one kernels.batched_gemm launch
               per wave + on-device gather and scatter-add (the
               cuBLAS-batched-gemm shape).
    device   : None -> the CUDA device (raises if there is none; nothing
               falls back on its own); 'cpu' runs the kernels' plain
               PyTorch versions, which is how the tests run without a card.
    validate_structure : cross-check the pure-Python output structure of
               every leaf task against bsmm.compute_c_structure (the
               boolean matmul).  Costs one torch call per leaf task; meant
               for tests.
    """

    name = "torch"

    @property
    def tracer(self):
        """The bound graph's tracer (NOOP until bound / when tracing off)."""
        g = self._graph
        return getattr(g, "tracer", NOOP) if g is not None else NOOP

    def __init__(self, kernel: str = "pairs", device=None,
                 validate_structure: bool = False):
        if kernel not in ("pairs", "gemm"):
            raise ValueError(f"unknown kernel {kernel!r}; pick 'pairs' or "
                             f"'gemm'")
        self.kernel = kernel
        self.device = resolve_device(device)
        self.validate_structure = validate_structure
        self._pending: list[_Pending] = []
        self._unfilled: set[int] = set()     # id() of placeholder out leaves
        self._waves: list[dict] = []
        self._graph = None                   # bound CTGraph (one per engine)

    # -- registration-time: structure only ----------------------------------
    def _bind(self, g) -> None:
        """One engine instance serves one graph: pending waves and stats are
        per-graph state, so sharing would flush foreign work as a side
        effect and conflate the flop/bytes report."""
        if g is None:
            return
        if self._graph is None:
            self._graph = g
        elif g is not self._graph:
            raise EngineRebindError(
                "this TorchEngine instance is already bound to another "
                "CTGraph; create one engine per graph")

    def execute(self, g, node, payload: LeafPayload) -> Optional[MatrixChunk]:
        # while tracing, each leaf task's C structure (and a truncated
        # multiply's kept-pair test) add to the tracer's engine.* counters
        # (per task: no span), timed on the tracer's clock, which leaves
        # the collector's passes out
        tr = g.tracer
        if not tr.enabled:
            return self._execute(g, node, payload)
        t0 = tr.clock()
        out = self._execute(g, node, payload)
        tr.add("engine.pairs_s", tr.clock() - t0)
        tr.add("engine.leaf_tasks")
        return out

    def _execute(self, g, node, payload: LeafPayload
                 ) -> Optional[MatrixChunk]:
        self._bind(g)
        av: MatrixChunk = g.value_of(payload.a)
        bv: Optional[MatrixChunk] = (
            g.value_of(payload.b) if payload.b is not None else None)
        a_leaf = av.leaf
        b_leaf = bv.leaf if bv is not None else None

        if payload.kind == "add":
            # adds run host-side (no kernel), so input precision is kept:
            # float64 for original data, float32 when fed by kernel results
            out = alloc_structure(
                a_leaf.n, a_leaf.bs,
                list(dict.fromkeys(list(a_leaf.blocks) + list(b_leaf.blocks))),
                upper=a_leaf.upper,
                dtype=np.result_type(a_leaf.dtype, b_leaf.dtype))
            self._defer(_Pending(node.nid, payload, out, a_leaf, b_leaf))
            return MatrixChunk(av.n, leaf=out, upper=av.upper)

        if payload.kind == "transpose":
            # host-side like add; deferred so it orders after the wave that
            # fills its input (structure is final at registration)
            out = alloc_structure(a_leaf.n, a_leaf.bs,
                                  [(j, i) for (i, j) in a_leaf.blocks],
                                  upper=False, dtype=a_leaf.dtype)
            self._defer(_Pending(node.nid, payload, out, a_leaf, None))
            return MatrixChunk(av.n, leaf=out)

        if payload.kind == "scale":
            # host-side like add/transpose: same structure, scaled numbers
            out = alloc_structure(a_leaf.n, a_leaf.bs, list(a_leaf.blocks),
                                  upper=a_leaf.upper, dtype=a_leaf.dtype)
            self._defer(_Pending(node.nid, payload, out, a_leaf, None))
            return MatrixChunk(av.n, leaf=out, upper=av.upper)

        if payload.kind in SOLVE_KINDS:
            # structure is a function of the operand structure alone
            # (deterministic keys, zero blocks kept — see core/leaf.py),
            # so deferral is safe exactly like the multiply kinds; the
            # numeric fill joins a batched triangular wave at flush
            if payload.kind == "inv_chol":
                keys = inv_chol_keys(a_leaf.grid)
            else:
                keys = tri_solve_keys(b_leaf.blocks, a_leaf.grid)
            node.flops = float(a_leaf.n) ** 3
            out = alloc_structure(a_leaf.n, a_leaf.bs, keys, upper=False,
                                  dtype=self._out_dtype(a_leaf, b_leaf))
            self._defer(_Pending(node.nid, payload, out, a_leaf, b_leaf))
            return MatrixChunk(av.n, leaf=out, upper=False)

        # C's keys in row-major slot order (the same order
        # bsmm.compute_c_structure assigns; see validate_structure) and the
        # pair count; the pairs themselves are joined at flush
        if truncates(payload):
            # the kept pairs decide C: freeze them for Plan replay (see
            # qt_replay), the norm test must not re-evaluate against
            # rebound values
            kept = node.replay = kept_pairs(payload, a_leaf, b_leaf,
                                            g.tracer)
            keys = list(zip(*(x.tolist() for x in np.divmod(
                np.unique(kept[0]), a_leaf.grid))))
            n_pairs, upper = kept.shape[1], False
        else:
            (_, first), (_, second), upper = task_views(payload, a_leaf,
                                                        b_leaf)
            keys, n_pairs = c_structure(first, second, upper)
            kept = None
        g.tracer.add("engine.pairs", n_pairs)
        node.flops = 2.0 * n_pairs * a_leaf.bs ** 3
        if self.validate_structure:
            oracle = self._c_keys(payload, a_leaf, b_leaf, upper)
            if truncates(payload):
                # the torch oracle evaluates the tau test in float32; allow
                # it to disagree only on pairs within f32 rounding of the
                # boundary by bracketing with slightly shifted taus
                def keys_at(t):
                    probe = dataclasses.replace(payload, tau=t, trunc=None)
                    prs, _ = leaf_task_pairs(probe, a_leaf, b_leaf)
                    return {p[6] for p in prs}
                strict = keys_at(payload.tau * (1 + 1e-5))
                loose = keys_at(payload.tau * (1 - 1e-5))
                assert strict <= set(oracle) <= loose
            else:
                assert keys == oracle
        if not keys:
            return None
        out = alloc_structure(a_leaf.n, a_leaf.bs, keys, upper=upper,
                              dtype=self._out_dtype(a_leaf, b_leaf))
        self._defer(_Pending(node.nid, payload, out, a_leaf, b_leaf, n_pairs,
                             kept))
        return MatrixChunk(av.n, leaf=out, upper=upper)

    @staticmethod
    def _out_dtype(a_leaf, b_leaf):
        # kernels compute in float32 (f32 accumulation): engine-produced
        # leaves are float32 so the stored dtype and bytes accounting are
        # truthful about precision
        _ = a_leaf, b_leaf
        return np.float32

    def _defer(self, entry: _Pending) -> None:
        self._pending.append(entry)
        self._unfilled.add(id(entry.out))

    def _c_keys(self, payload, a_leaf, b_leaf, upper) -> list:
        """Output occupancy via the one-shot boolean matmul of bsmm.

        The operand masks are the op-applied structure views; the C keys come
        back in compute_c_structure's row-major slot order, which fixes the
        packed output slot numbering of the flush wave.  A truncated
        multiply (``payload.tau > 0``) cross-checks against the
        norm-weighted structure (:func:`~repro_torch.core.bsmm
        .compute_c_structure_norms`) instead: a C block survives only if
        some inner pair's norm product clears tau.
        """
        from .bsmm import compute_c_structure, compute_c_structure_norms

        grid = a_leaf.grid
        if truncates(payload):
            na = np.zeros((grid, grid))
            nb = np.zeros((grid, grid))
            for i, k, key, _ in _plain_items(a_leaf, payload.ta):
                na[i, k] = math.sqrt(a_leaf.block_norm2(key))
            for k, j, key, _ in _plain_items(b_leaf, payload.tb):
                nb[k, j] = math.sqrt(b_leaf.block_norm2(key))
            crows, ccols, _, cnt = compute_c_structure_norms(
                torch.from_numpy(na).float(), torch.from_numpy(nb).float(),
                payload.tau, cap_c=grid * grid)
            cnt = int(cnt)
            return [(int(r), int(c)) for r, c
                    in zip(np.asarray(crows)[:cnt], np.asarray(ccols)[:cnt])]

        ma = np.zeros((grid, grid), bool)
        mb = np.zeros((grid, grid), bool)
        kfirst = payload.kind
        if kfirst == "multiply":
            for i, k, _, _ in _plain_items(a_leaf, payload.ta):
                ma[i, k] = True
            for k, j, _, _ in _plain_items(b_leaf, payload.tb):
                mb[k, j] = True
        elif kfirst == "sym_square":
            for i, k, _, _ in _full_items(a_leaf):
                ma[i, k] = True
            mb = ma
        elif kfirst == "syrk":
            for i, k, _, _ in _plain_items(a_leaf, payload.trans):
                ma[i, k] = True
            mb = ma.T
        elif kfirst == "sym_multiply":
            if payload.side == "left":
                for i, k, _, _ in _full_items(a_leaf):
                    ma[i, k] = True
                for k, j, _, _ in _plain_items(b_leaf, False):
                    mb[k, j] = True
            else:
                for i, k, _, _ in _plain_items(b_leaf, False):
                    ma[i, k] = True
                for k, j, _, _ in _full_items(a_leaf):
                    mb[k, j] = True
        crows, ccols, _, cnt = compute_c_structure(
            torch.from_numpy(ma), torch.from_numpy(mb), cap_c=grid * grid)
        cnt = int(cnt)
        keys = [(int(r), int(c)) for r, c
                in zip(np.asarray(crows)[:cnt], np.asarray(ccols)[:cnt])]
        if upper:
            keys = [k for k in keys if k[0] <= k[1]]
        return keys

    # -- flush: batched waves ------------------------------------------------
    def _ready(self, t: _Pending) -> bool:
        if id(t.a_leaf) in self._unfilled:
            return False
        return t.b_leaf is None or id(t.b_leaf) not in self._unfilled

    def batch_key(self, t: _Pending) -> tuple:
        """Wave-compatibility key of a deferred kernel task.

        Tasks agreeing on ``(kernel, leaf_n, bs, dtype)`` may share one
        fused dispatch — within this engine's waves and, through the
        serving layer's cross-plan coalescer (:mod:`repro_torch.serve`),
        across engines of different sessions.
        """
        return (self.kernel, t.out.n, t.out.bs,
                np.dtype(t.out.dtype).name)

    def has_pending_for(self, leaf_ids) -> bool:
        for t in self._pending:
            if id(t.out) in leaf_ids or id(t.a_leaf) in leaf_ids or \
                    (t.b_leaf is not None and id(t.b_leaf) in leaf_ids):
                return True
        return False

    def ready_wave(self) -> dict:
        """Ready deferred kernel tasks, grouped by :meth:`batch_key`.

        Read-only: nothing is executed or committed.  The cross-plan
        coalescer merges groups with equal keys across engines before
        dispatching; :meth:`flush` consumes the same grouping locally.
        """
        groups: dict[tuple, list[_Pending]] = {}
        for t in self._pending:
            if t.payload.kind not in HOST_KINDS \
                    and t.payload.kind not in SOLVE_KINDS \
                    and self._ready(t):
                groups.setdefault(self.batch_key(t), []).append(t)
        return groups

    def solve_wave(self) -> dict:
        """Ready deferred triangular-solve tasks, grouped for batching.

        Solve kinds never join GEMM waves: they dispatch through
        kernels/tri.py one batched call per ``(kind, leaf_n, bs)`` group.
        """
        groups: dict[tuple, list[_Pending]] = {}
        for t in self._pending:
            if t.payload.kind in SOLVE_KINDS and self._ready(t):
                key = (t.payload.kind, t.out.n, t.out.bs)
                groups.setdefault(key, []).append(t)
        return groups

    def run_solve_ready(self) -> bool:
        """Dispatch every ready batched triangular wave; True if any ran."""
        groups = self.solve_wave()
        self._run_waves(groups, lambda key, tasks: dispatch_solve_wave(
            tasks, kind=key[0], n=key[1], bs=key[2], device=self.device))
        return bool(groups)

    def run_host_ready(self) -> bool:
        """Execute every ready host-side fill (add/transpose/scale).

        Returns True if anything ran — the progress signal both
        :meth:`flush` and the coalescer's drain loop use.
        """
        progressed = False
        rest = []
        for t in self._pending:
            if t.payload.kind in HOST_KINDS and self._ready(t):
                if t.payload.kind == "add":
                    self._run_add(t)
                elif t.payload.kind == "scale":
                    self._run_scale(t)
                else:
                    self._run_transpose(t)
                self._unfilled.discard(id(t.out))
                progressed = True
            else:
                rest.append(t)
        self._pending = rest
        return progressed

    def commit_tasks(self, tasks: list, wave_record: Optional[dict] = None
                     ) -> None:
        """Retire externally executed tasks (cross-engine coalescer).

        The coalescer packs this engine's share of a merged wave into one
        dispatch it runs itself, then commits the share here so the next
        flush does not re-run it.  ``wave_record`` (this engine's slice
        of the merged wave's accounting) lands in the wave log.
        """
        done = {id(t) for t in tasks}
        for t in tasks:
            self._unfilled.discard(id(t.out))
        self._pending = [t for t in self._pending if id(t) not in done]
        if wave_record is not None:
            self._waves.append(wave_record)

    def flush(self, g=None) -> None:
        # tasks leave self._pending only after their wave succeeded, so a
        # kernel failure leaves the deferred work intact and a later flush
        # retries it (block fills are idempotent in-place assignments)
        self._bind(g)
        while self._pending:
            groups = self.ready_wave()
            self._run_waves(groups, self._run_group)   # commits per group
            progressed = bool(groups)
            progressed |= self._host_fill()
            progressed |= self.run_solve_ready()
            if self._pending and not progressed:
                raise RuntimeError(
                    "leaf engine deadlock: unresolvable leaf dependencies")

    def _host_fill(self) -> bool:
        """:meth:`run_host_ready`, inside an ``engine.host_fill`` span
        (attrs: adds, transposes, scales) when tracing and it runs any."""
        tr = self.tracer
        if not tr.enabled:
            return self.run_host_ready()
        if not any(t.payload.kind in HOST_KINDS and self._ready(t)
                   for t in self._pending):
            return False
        before = self._pending
        with tr.span("engine.host_fill", track="engine") as sp:
            self.run_host_ready()
            left = {id(t) for t in self._pending}
            ran = [t.payload.kind for t in before if id(t) not in left]
            sp.set(adds=ran.count("add"), transposes=ran.count("transpose"),
                   scales=ran.count("scale"))
        return True

    @staticmethod
    def _run_add(t: _Pending) -> None:
        for key, blk in t.out.blocks.items():
            a = t.a_leaf.blocks.get(key)
            b = t.b_leaf.blocks.get(key)
            if a is None:
                blk[...] = b
            elif b is None:
                blk[...] = a
            else:
                np.add(a, b, out=blk, casting="unsafe")
        t.out.invalidate_norms()

    @staticmethod
    def _run_transpose(t: _Pending) -> None:
        for (i, j), blk in t.a_leaf.blocks.items():
            t.out.blocks[(j, i)][...] = blk.T
        t.out.invalidate_norms()

    @staticmethod
    def _run_scale(t: _Pending) -> None:
        for key, blk in t.a_leaf.blocks.items():
            np.multiply(blk, t.payload.alpha, out=t.out.blocks[key],
                        casting="unsafe")
        t.out.invalidate_norms()

    def reexecute(self, g, node, payload: LeafPayload) -> None:
        """Re-defer an already-executed leaf task against its existing
        output chunk; the next flush re-runs the batched waves/host fills
        in dependency order, writing the same placeholder blocks.  Counted
        while tracing as :meth:`execute` is; the structure cannot change
        across a rebind, so nothing about pairs is built here: an exact
        task's are joined at flush as a fresh product's, a truncated
        multiply's replay its frozen columns."""
        tr = g.tracer
        if not tr.enabled:
            return self._reexecute(g, node, payload)
        t0 = tr.clock()
        self._reexecute(g, node, payload)
        tr.add("engine.pairs_s", tr.clock() - t0)
        tr.add("engine.leaf_tasks")

    def _reexecute(self, g, node, payload: LeafPayload) -> None:
        self._bind(g)
        av: MatrixChunk = g.value_of(payload.a)
        bv: Optional[MatrixChunk] = (
            g.value_of(payload.b) if payload.b is not None else None)
        a_leaf = av.leaf
        b_leaf = bv.leaf if bv is not None else None
        out: MatrixChunk = g.value_of(node.nid)
        if payload.kind in HOST_KINDS or payload.kind in SOLVE_KINDS:
            # host fills and solve waves assign (not scatter-add) every
            # output block, so re-deferring without zeroing is exact
            self._defer(_Pending(node.nid, payload, out.leaf, a_leaf,
                                 b_leaf))
        else:
            kept = node.replay              # frozen at first execution
            # the first execution's count (node.flops is 2 bs^3 a pair)
            n_pairs = kept.shape[1] if truncates(payload) \
                else int(node.flops) // (2 * a_leaf.bs ** 3)
            g.tracer.add("engine.pairs", n_pairs)
            # zero first: waves only scatter-add into surviving out slots
            for blk in out.leaf.blocks.values():
                blk[...] = 0.0
            self._defer(_Pending(node.nid, payload, out.leaf, a_leaf,
                                 b_leaf, n_pairs, kept))
        out.norm2 = None
        out.trace = None

    def _wave_span_attrs(self) -> dict:
        """Attributes of the just-committed wave for its engine.wave span."""
        w = self._waves[-1]
        return {k: w[k] for k in ("kernel", "bs", "tasks", "pairs",
                                  "padded_pairs", "c_blocks", "bytes_packed")
                if k in w}

    def _run_waves(self, groups: dict, dispatch) -> None:
        """Each group as one wave in an ``engine.wave`` span;
        ``dispatch(key, tasks)`` runs it and returns its record."""
        for key, tasks in sorted(groups.items()):
            with self.tracer.span("engine.wave", track="engine") as sp:
                self._waves.append(dispatch(key, tasks))
                sp.set(**self._wave_span_attrs())
            self._waves[-1].setdefault("batch_key", list(key))
            # commit this group immediately: a failure in a *later* group
            # must not leave these tasks pending, or a retrying flush would
            # re-run them and double-count their wave record in stats()
            self.commit_tasks(tasks)

    def _run_group(self, key: tuple, tasks: list[_Pending]) -> dict:
        """One kernel call for every block pair of the wave; returns its
        record."""
        return dispatch_packed_wave(tasks, key[2], kernel=self.kernel,
                                    device=self.device, tracer=self.tracer)

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict:
        return {
            "backend": self.name,
            "kernel": self.kernel,
            "waves": len(self._waves),
            "batched_pairs": sum(w["pairs"] for w in self._waves),
            "padded_pairs": sum(w["padded_pairs"] for w in self._waves),
            "c_blocks": sum(w["c_blocks"] for w in self._waves),
            "kernel_wall_s": sum(w["wall_s"] for w in self._waves),
            "bytes_packed": sum(w["bytes_packed"] for w in self._waves),
            "wave_log": list(self._waves),
        }


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor, through pinned memory for CUDA."""
    t = torch.from_numpy(arr)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dispatch_solve_wave(tasks: list[_Pending], *, kind: str, n: int,
                        bs: int, device: torch.device) -> dict:
    """One batched triangular call for every ready solve leaf.

    Leaves are densified host-side (symmetric upper storage expands to
    full), stacked ``(P, n, n)`` in float32, run through
    :mod:`repro_torch.kernels.tri` on the engine's device, and scattered
    back into each task's pre-allocated deterministic block structure.
    Returns a wave record with the same accounting fields as the GEMM
    waves (``pairs`` counts leaves here — one "pair" of dense operands per
    task).
    """
    from repro_torch.kernels import tri as ktri

    a_pack = np.stack([t.a_leaf.to_dense() for t in tasks]).astype(np.float32)
    t0 = time.perf_counter()
    if kind == "inv_chol":
        res = ktri.batched_inv_chol(_to_device(a_pack, device))
        b_bytes = 0
    else:
        b_pack = np.stack([t.b_leaf.to_dense()
                           for t in tasks]).astype(np.float32)
        res = ktri.batched_tri_solve(_to_device(a_pack, device),
                                     _to_device(b_pack, device))
        b_bytes = b_pack.nbytes
    res = res.cpu().numpy()
    _sync(device)
    wall = time.perf_counter() - t0

    c_blocks = 0
    for t, x in zip(tasks, res):
        keys = list(t.out.blocks)
        data = np.stack([np.ascontiguousarray(
            x[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs]) for i, j in keys])
        unpack_blocks(t.out, keys, data)
        c_blocks += len(keys)
    return {
        "kernel": kind, "bs": bs, "tasks": len(tasks),
        "pairs": len(tasks), "padded_pairs": len(tasks),
        "c_blocks": int(c_blocks), "wall_s": wall,
        "bytes_packed": int(a_pack.nbytes + b_bytes
                            + res.astype(np.float32).nbytes),
    }


@dataclasses.dataclass(frozen=True)
class WaveNumbering:
    """A kernel wave's pairs as columns, a row a pair in the wave's pair
    order (tasks in order, each task's pairs in ascending ``(k, i, j)`` of
    its products ``C_ij += A_ik B_kj``, so each C block takes its pairs in
    task order, then ascending k, whichever tasks share the wave): its
    ``task``, its
    C ``slot`` (task ``t`` holds ``slot_base[t]`` up to ``slot_base[t +
    1]``, in ``t.out.blocks`` order) and its operands' ``code`` (sides a,
    b), ``(leaf * grid**2 + i * grid + j) * 2 + transpose`` for block
    ``(i, j)`` of ``leaves[leaf]``, numbered by first appearance in the
    wave so that every rank running the same tasks numbers alike."""
    task: np.ndarray
    slot: np.ndarray
    slot_base: np.ndarray
    code: np.ndarray
    leaves: list
    grid: int

    def blocks(self, codes: np.ndarray) -> list:
        """``(leaf, key, transpose)`` of each code."""
        leaf, rest = np.divmod(codes, 2 * self.grid * self.grid)
        i, j = np.divmod(rest // 2, self.grid)
        return list(zip([self.leaves[x] for x in leaf.tolist()],
                        zip(i.tolist(), j.tolist()), (rest % 2 == 1).tolist()))

    def stack(self, codes: np.ndarray, rows: int) -> np.ndarray:
        """The blocks of ``codes`` as a C-order float32 ``(rows, bs, bs)``
        stack, zero past them, each element rounded once from its leaf
        (np.stack alone would follow the layout of transposed views)."""
        bs = self.leaves[0].bs
        pack = np.empty((rows, bs, bs), np.float32)
        pack[len(codes):] = 0
        if len(codes):
            np.stack([leaf.blocks[key].T if tr else leaf.blocks[key]
                      for leaf, key, tr in self.blocks(codes)],
                     out=pack[:len(codes)])
        return pack


def number_wave(tasks: list[_Pending], tracer=NOOP) -> WaveNumbering:
    """The wave's :class:`WaveNumbering`, as array work.  The pairs of the
    tasks that froze none come from one join over the wave: each task's
    operand blocks, from their leaves' cached :class:`LeafView`, paired
    on ``(task, k)``, the lower triangle dropped where C is kept upper
    (``engine.pairs_joined`` counts them).  A truncated multiply's frozen
    columns (``kept``) join them in task order."""
    grid = tasks[0].out.grid                 # one batch_key
    cells = grid * grid
    leaves = list({id(x): x for t in tasks for x in (t.a_leaf, t.b_leaf)
                   if x is not None}.values())
    leaf_ix = {id(x): i for i, x in enumerate(leaves)}

    # per side, each joined task's (task, code offset, columns)
    sides: tuple = ([], [])
    upper = np.zeros(len(tasks), bool)
    frozen = []
    for n, t in enumerate(tasks):
        if t.kept is not None:
            frozen.append(n)
            continue
        first, second, upper[n] = task_views(t.payload, t.a_leaf, t.b_leaf)
        for side, (leaf, v), cols in zip(sides, (first, second),
                                         ("first", "second")):
            side.append((n, leaf_ix[id(leaf)] * 2 * cells,
                         getattr(v, cols)))

    def columns(parts):
        lens = [len(p[2][0]) for p in parts]
        task = np.repeat([p[0] for p in parts], lens)
        k, other, code = (np.concatenate([p[2][x] for p in parts])
                          for x in range(3))
        return task, k, other, code + np.repeat([p[1] for p in parts], lens)

    task = np.zeros(0, np.int64)
    cell = np.zeros(0, np.int64)
    code = np.zeros((0, 2), np.int64)
    if sides[0]:
        ta, ka, i, ca = columns(sides[0])
        tb, kb, j, cb = columns(sides[1])
        ra, rb = join_items(ta * grid + ka, tb * grid + kb,
                            len(tasks) * grid)
        task, i, j = ta[ra], i[ra], j[rb]
        keep = ~(upper[task] & (i > j))
        task, i, j, ra, rb = task[keep], i[keep], j[keep], ra[keep], rb[keep]
        cell = i * grid + j
        code = np.stack([ca[ra], cb[rb]], axis=1)
    tracer.add("engine.pairs_joined", len(task))
    if frozen:
        kept = [tasks[n].kept for n in frozen]
        lens = [x.shape[1] for x in kept]
        kept = np.concatenate(kept, axis=1)
        offs = np.array([[leaf_ix[id(tasks[n].a_leaf)],
                          leaf_ix[id(tasks[n].b_leaf)]]
                         for n in frozen]) * 2 * cells
        task = np.concatenate([task, np.repeat(frozen, lens)])
        cell = np.concatenate([cell, kept[0]])
        code = np.concatenate([code, kept[1:].T + np.repeat(offs, lens,
                                                            axis=0)])
        if len(frozen) < len(tasks):
            order = np.argsort(task, kind="stable")
            task, cell, code = task[order], cell[order], code[order]

    # C slots: each task's keys, coded with the task's number
    out_lens = [len(t.out.blocks) for t in tasks]
    slot_base = np.concatenate(([0], np.cumsum(out_lens)))
    c_code = np.concatenate([leaf_keys(t.out) for t in tasks]) \
        + np.repeat(np.arange(len(tasks)) * cells, out_lens)
    p_code = cell + task * cells
    by_code = np.argsort(c_code)
    slot = by_code[np.minimum(np.searchsorted(c_code, p_code, sorter=by_code),
                              slot_base[-1] - 1)]
    if not np.array_equal(c_code[slot], p_code):
        raise KeyError("a block pair's output key is not in its task's "
                       "C structure")
    return WaveNumbering(task, slot, slot_base, code, leaves, grid)


def number_by_first(codes: np.ndarray) -> tuple:
    """``(number, first)``: each code's number, equal codes alike, by
    first occurrence, and each number's first position."""
    _, first, inverse = np.unique(codes, return_index=True,
                                  return_inverse=True)
    by_first = np.argsort(first)
    rank = np.empty_like(by_first)
    rank[by_first] = np.arange(len(by_first))
    return rank[inverse], first[by_first]


def gather_wave(tasks: list[_Pending], tracer=NOOP) -> tuple:
    """Pack one kernel wave: ``(sa, sb, seg, a_pack, b_pack, n_slots)``.

    Each side's operands are packed *uniquely*, by first occurrence of
    their :func:`number_wave` codes.  Pair ``p`` multiplies
    ``a_pack[sa[p]] @ b_pack[sb[p]]`` into C slot ``seg[p]``.  ``seg`` is
    ascending (a *stable* sort, so each C block keeps its pairs in the
    wave's pair order), ``sa`` and ``sb`` permuted with it, all int32."""
    num = number_wave(tasks, tracer)
    order = np.argsort(num.slot, kind="stable")   # bsmm_pairs contract
    out = []
    for codes in num.code.T:
        slots, first = number_by_first(codes)
        out.append(slots[order].astype(np.int32))
        out.append(num.stack(codes[first], len(first)))
    sa, a_pack, sb, b_pack = out
    return (sa, sb, num.slot[order].astype(np.int32), a_pack, b_pack,
            int(num.slot_base[-1]))


def dispatch_packed_wave(tasks: list[_Pending], bs: int, *, kernel: str,
                         device: torch.device, tracer=NOOP) -> dict:
    """Pack every block pair of every leaf task into one kernel launch.

    Module-level so a cross-plan coalescer can merge same-``batch_key``
    tasks *from several engines* into one dispatch.  Fills each task's
    output leaf in place and returns the wave record (the caller appends
    it to the owning engine's wave log).

    Numerical identity with per-engine dispatch: output slots are numbered
    task-by-task in structure order, each task's pairs come in ascending
    ``(k, i, j)`` and are sorted by a *stable* argsort on segment id, so
    every output block accumulates its products in the same order
    regardless of which other tasks share the wave.
    ``wall_s`` spans the copies to the device, the kernel and the copy
    back, and ends in a device synchronize.
    """
    from repro_torch.kernels import ops as kops

    with tracer.span("engine.gather", track="engine") as sp:
        sa, sb, seg, a_pack, b_pack, n_slots = gather_wave(tasks, tracer)
        n_pairs = len(seg)
        unique_blocks = len(a_pack) + len(b_pack)
        sp.set(pairs=n_pairs, unique_blocks=unique_blocks)

    t0 = time.perf_counter()
    with tracer.span("kernel.dispatch", track="engine",
                     kernel=kernel, bs=bs,
                     pairs=int(n_pairs), c_blocks=int(n_slots)):
        with tracer.span("copy.h2d", track="engine"):
            a_dev = _to_device(a_pack, device)
            b_dev = _to_device(b_pack, device)
            sa_dev = _to_device(sa, device)
            sb_dev = _to_device(sb, device)
            seg_dev = _to_device(seg, device)
        if kernel == "pairs":
            c_dev = kops.bsmm_pairs(a_dev, b_dev, sa_dev, sb_dev, seg_dev,
                                    cap_c=n_slots)
            padded = n_pairs
        else:
            # the gather and the segment sum run on the device around the
            # batched kernel; the record counts the reference's padding
            prods = kops.batched_gemm(a_dev[sa_dev.long()],
                                      b_dev[sb_dev.long()])
            c_dev = torch.zeros((n_slots, bs, bs), dtype=torch.float32,
                                device=device)
            c_dev.index_add_(0, seg_dev.long(), prods)
            padded = n_pairs + (-n_pairs) % GEMM_BATCH_TILE
        with tracer.span("copy.d2h", track="engine"):
            c = c_dev.cpu().numpy()
            _sync(device)
    wall = time.perf_counter() - t0

    record = {
        "kernel": kernel, "bs": bs, "tasks": len(tasks),
        "pairs": int(n_pairs), "padded_pairs": int(padded),
        "unique_blocks": unique_blocks,
        "c_blocks": int(n_slots), "wall_s": wall,
        "bytes_packed": int(a_pack.nbytes + b_pack.nbytes + c.nbytes),
    }
    with tracer.span("engine.scatter", track="engine"):
        base = 0
        for t in tasks:
            keys = list(t.out.blocks)
            unpack_blocks(t.out, keys, c[base:base + len(keys)])
            base += len(keys)
    return record
