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
  masks — the create-from-ids tree collapsed to one boolean matmul) and
  zero placeholder blocks are allocated, while the numeric work is
  deferred.  At flush time the engine harvests *all* pending leaf tasks
  across the whole quadtree, packs every surviving block pair of every leaf
  into one ``(P, bs, bs)`` operand stream, copies it to the card and makes
  **one kernel launch per wave** — the hand-written CUDA
  ``kernels.bsmm_pairs`` (gather-GEMM-scatter) or ``kernels.batched_gemm``
  followed by an on-device scatter-add.  This lifts the paper's Fig 2
  outer-product batching from per-leaf to per-graph: cross-leaf batching.

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
    """Resolve an engine spec: None/'torch' (the card), 'numpy', or an
    instance."""
    if spec is None or spec == "torch":
        return TorchEngine()
    if spec == "numpy":
        return NumpyEngine()
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


def leaf_task_pairs(payload: LeafPayload, a_leaf: LeafMatrix,
                    b_leaf: Optional[LeafMatrix]):
    """All surviving block GEMMs of one leaf task.

    Returns ``(pairs, upper_out)`` where each pair is
    ``(src_a, key_a, trans_a, src_b, key_b, trans_b, out_key)`` with src in
    {'a', 'b'} naming which operand leaf the stored block comes from.  The
    pair count equals the numpy backend's LeafStats.block_multiplies.
    """
    k = payload.kind
    if k == "multiply":
        assert not a_leaf.upper and not b_leaf.upper  # host-library contract
        first = ("a", _plain_items(a_leaf, payload.ta))
        second = ("b", _plain_items(b_leaf, payload.tb))
        upper = False
    elif k == "sym_square":
        assert a_leaf.upper
        first = ("a", _full_items(a_leaf))
        second = ("a", _full_items(a_leaf))
        upper = True
    elif k == "syrk":
        assert not a_leaf.upper
        if payload.trans:   # C = A^T A
            first = ("a", _plain_items(a_leaf, True))
            second = ("a", _plain_items(a_leaf, False))
        else:               # C = A A^T
            first = ("a", _plain_items(a_leaf, False))
            second = ("a", _plain_items(a_leaf, True))
        upper = True
    elif k == "sym_multiply":
        assert a_leaf.upper and not b_leaf.upper
        if payload.side == "left":      # C = S B
            first = ("a", _full_items(a_leaf))
            second = ("b", _plain_items(b_leaf, False))
        else:                            # C = B S
            first = ("b", _plain_items(b_leaf, False))
            second = ("a", _full_items(a_leaf))
        upper = False
    else:
        raise ValueError(f"not a multiply-kind payload: {k}")

    cols: dict[int, list] = {}
    for i, kk, key, tr in first[1]:
        cols.setdefault(kk, []).append((i, first[0], key, tr))
    rows: dict[int, list] = {}
    for kk, j, key, tr in second[1]:
        rows.setdefault(kk, []).append((j, second[0], key, tr))

    pairs = []
    for kk in cols.keys() & rows.keys():
        for i, sa, ka, tra in cols[kk]:
            for j, sb, kb, trb in rows[kk]:
                if upper and i > j:
                    continue        # lower triangle skipped: symmetry saving
                pairs.append((sa, ka, tra, sb, kb, trb, (i, j)))

    if payload.tau > 0.0 and k == "multiply":
        # SpAMM pruning inside the leaf (DESIGN.md §5): a block pair whose
        # norm product is below tau is dropped *structurally* — both
        # backends take their structure from this list, so pruned pairs
        # never enter a kernel wave and never touch the host library.
        # Block norms are transpose-invariant: the stored key's cached
        # norm is valid for either orientation.
        srcs = {"a": a_leaf, "b": b_leaf}
        flops_each = 2.0 * a_leaf.bs ** 3
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
        pairs = kept
    return pairs, upper


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
        if k == "multiply" and payload.tau > 0.0:
            # truncated path: structure (incl. SpAMM pair pruning) comes
            # from leaf_task_pairs — identical to the torch backend's —
            # and the surviving pairs are evaluated with the host library.
            # The pair list is frozen on the node so a Plan replay re-runs
            # the same program instead of re-pruning against new norms.
            if node.replay is None:
                node.replay = leaf_task_pairs(payload, av.leaf, bv.leaf)
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
    pairs: Optional[list] = None    # multiply kinds only


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``None`` means CUDA, which must be present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchEngine runs its kernels on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions instead")
        device = "cuda"
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"TorchEngine runs on 'cuda' or 'cpu', not {device}")
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
    block_t  : batch tile of the reference's batched_gemm kernel; the wave
               record still counts the pairs padded to a multiple of it
               (``padded_pairs``), though the CUDA kernel needs no padding.
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

    def __init__(self, kernel: str = "pairs", device=None, block_t: int = 8,
                 validate_structure: bool = False):
        if kernel not in ("pairs", "gemm"):
            raise ValueError(f"unknown kernel {kernel!r}; pick 'pairs' or "
                             f"'gemm'")
        self.kernel = kernel
        self.device = resolve_device(device)
        self.block_t = block_t
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

        pairs, upper = leaf_task_pairs(payload, a_leaf, b_leaf)
        if payload.tau > 0.0:
            # freeze the surviving pairs for Plan replay (see qt_replay):
            # the norm test must not re-evaluate against rebound values
            node.replay = (pairs, upper)
        node.flops = 2.0 * len(pairs) * a_leaf.bs ** 3
        # output occupancy in row-major slot order (the same order
        # bsmm.compute_c_structure assigns; see validate_structure)
        keys = sorted({p[6] for p in pairs})
        if self.validate_structure:
            oracle = self._c_keys(payload, a_leaf, b_leaf, upper)
            if payload.tau > 0.0:
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
        self._defer(_Pending(node.nid, payload, out, a_leaf, b_leaf, pairs))
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
        if payload.kind == "multiply" and payload.tau > 0.0:
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
        progressed = False
        for key, tasks in sorted(self.solve_wave().items()):
            kind, n, bs = key
            tr = self.tracer
            if tr.enabled:
                with tr.span("engine.wave", track="engine") as sp:
                    self._waves.append(dispatch_solve_wave(
                        tasks, kind=kind, n=n, bs=bs, device=self.device))
                    sp.set(**self._wave_span_attrs())
            else:
                self._waves.append(dispatch_solve_wave(
                    tasks, kind=kind, n=n, bs=bs, device=self.device))
            self._waves[-1].setdefault("batch_key", list(key))
            self.commit_tasks(tasks)
            progressed = True
        return progressed

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
            if groups:
                self._run_wave(groups)   # commits per group (see below)
            progressed = bool(groups)
            progressed |= self.run_host_ready()
            progressed |= self.run_solve_ready()
            if self._pending and not progressed:
                raise RuntimeError(
                    "leaf engine deadlock: unresolvable leaf dependencies")

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
        in dependency order, writing the same placeholder blocks."""
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
            if payload.tau > 0.0:
                pairs, _ = node.replay      # frozen at first execution
            else:
                probe = dataclasses.replace(payload, trunc=None)
                pairs, _ = leaf_task_pairs(probe, a_leaf, b_leaf)
            # zero first: waves only scatter-add into surviving out slots
            for blk in out.leaf.blocks.values():
                blk[...] = 0.0
            self._defer(_Pending(node.nid, payload, out.leaf, a_leaf,
                                 b_leaf, pairs))
        out.norm2 = None
        out.trace = None

    def _wave_span_attrs(self) -> dict:
        """Attributes of the just-committed wave for its engine.wave span."""
        w = self._waves[-1]
        return {k: w[k] for k in ("kernel", "bs", "tasks", "pairs",
                                  "padded_pairs", "c_blocks", "bytes_packed")
                if k in w}

    def _run_wave(self, groups: dict[tuple, list[_Pending]]) -> None:
        tr = self.tracer
        for key, tasks in sorted(groups.items()):
            if tr.enabled:
                with tr.span("engine.wave", track="engine") as sp:
                    self._run_group(key[2], tasks)
                    sp.set(**self._wave_span_attrs())
            else:
                self._run_group(key[2], tasks)
            self._waves[-1].setdefault("batch_key", list(key))
            # commit this group immediately: a failure in a *later* group
            # must not leave these tasks pending, or a retrying flush would
            # re-run them and double-count their wave record in stats()
            self.commit_tasks(tasks)

    def _run_group(self, bs: int, tasks: list[_Pending]) -> None:
        """Pack every block pair of every leaf task into one kernel call."""
        self._waves.append(dispatch_packed_wave(
            tasks, bs, kernel=self.kernel, block_t=self.block_t,
            device=self.device, tracer=self.tracer))

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


def dispatch_packed_wave(tasks: list[_Pending], bs: int, *, kernel: str,
                         block_t: int, device: torch.device,
                         tracer=NOOP) -> dict:
    """Pack every block pair of every leaf task into one kernel launch.

    Module-level so a cross-plan coalescer can merge same-``batch_key``
    tasks *from several engines* into one dispatch.  Fills each task's
    output leaf in place and returns the wave record (the caller appends
    it to the owning engine's wave log).

    Numerical identity with per-engine dispatch: output slots are numbered
    task-by-task in structure order and pairs are sorted by a *stable*
    argsort on segment id, so every output block accumulates its products
    in the same order regardless of which other tasks share the wave.
    ``wall_s`` spans the copies to the device, the kernel and the copy
    back, and ends in a device synchronize.
    """
    from repro_torch.kernels import ops as kops

    # global output slot numbering: task-by-task, structure order
    slot_base: list[int] = []
    n_slots = 0
    for t in tasks:
        slot_base.append(n_slots)
        n_slots += len(t.out.blocks)

    # operands are packed *uniquely* — one slot per distinct
    # (leaf, key, transpose) block — and pairs address them through
    # sa/sb indices, which is exactly the slot-indexed gather the
    # bsmm_pairs kernel is built around
    n_pairs = sum(len(t.pairs) for t in tasks)
    a_slots: dict[tuple, int] = {}
    b_slots: dict[tuple, int] = {}
    a_list: list[np.ndarray] = []
    b_list: list[np.ndarray] = []

    def slot_of(slots, lst, leaf, key, tr):
        sk = (id(leaf), key, tr)
        s = slots.get(sk)
        if s is None:
            s = len(lst)
            slots[sk] = s
            blk = leaf.blocks[key]
            lst.append(blk.T if tr else blk)
        return s

    sa = np.empty((n_pairs,), np.int32)
    sb = np.empty((n_pairs,), np.int32)
    seg = np.empty((n_pairs,), np.int32)
    p = 0
    for base, t in zip(slot_base, tasks):
        key_slot = {key: base + i for i, key in enumerate(t.out.blocks)}
        srcs = {"a": t.a_leaf, "b": t.b_leaf}
        for src_a, ka, tra, src_b, kb, trb, out_key in t.pairs:
            sa[p] = slot_of(a_slots, a_list, srcs[src_a], ka, tra)
            sb[p] = slot_of(b_slots, b_list, srcs[src_b], kb, trb)
            seg[p] = key_slot[out_key]
            p += 1
    # C order: stacked transposed views would otherwise keep their layout,
    # and the kernels take contiguous (P, bs, bs) stacks
    a_pack = np.stack(a_list).astype(np.float32, order="C")
    b_pack = np.stack(b_list).astype(np.float32, order="C")

    # ascending segment ids (bsmm_pairs accumulation contract)
    order = np.argsort(seg, kind="stable")
    sa, sb, seg = sa[order], sb[order], seg[order]

    t0 = time.perf_counter()
    with tracer.span("kernel.dispatch", track="engine",
                     kernel=kernel, bs=bs,
                     pairs=int(n_pairs), c_blocks=int(n_slots)):
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
            # batched kernel; the record still counts the reference's
            # padding of the batch to a multiple of block_t
            prods = kops.batched_gemm(a_dev[sa_dev.long()],
                                      b_dev[sb_dev.long()])
            c_dev = torch.zeros((n_slots, bs, bs), dtype=torch.float32,
                                device=device)
            c_dev.index_add_(0, seg_dev.long(), prods)
            padded = n_pairs + (-n_pairs) % block_t
        c = c_dev.cpu().numpy()
        _sync(device)
    wall = time.perf_counter() - t0

    record = {
        "kernel": kernel, "bs": bs, "tasks": len(tasks),
        "pairs": int(n_pairs), "padded_pairs": int(padded),
        "unique_blocks": len(a_list) + len(b_list),
        "c_blocks": int(n_slots), "wall_s": wall,
        "bytes_packed": int(a_pack.nbytes + b_pack.nbytes + c.nbytes),
    }
    for base, t in zip(slot_base, tasks):
        unpack_blocks(t.out, list(t.out.blocks),
                      c[base:base + len(t.out.blocks)])
    return record
