"""Capacity-bounded block-sparse matrix-matrix multiply (torch).

The port of ``repro/core/bsmm.py``, the paper's multiply (Algorithm 1 +
§4.1) on packed tensors:

1. **Enumerate** surviving (i, k, j) triples hierarchically through the mask
   pyramid (quadtree NIL-pruning, cost ∝ the paper's task count);
2. **Gather** the A[i,k] and B[k,j] packed blocks (the paper's chunk fetch);
3. **Batched GEMM** all pairs at once — the paper's sum-of-outer-products /
   cuBLAS-batched-gemm structure (Fig 2), here one launch of the
   ``batched_gemm`` kernel;
4. **Scatter-add** products into C's packed slots via a segment sum — the
   paper's addition-task tree collapsed into one associative reduction.

``use_pair_kernel=True`` fuses 2-4 into one ``bsmm_pairs`` launch.  Both
kernels go through :mod:`repro_torch.kernels.ops`: on a CUDA tensor the
hand-written kernel, on a CPU tensor its plain version.  Capacities come
from host-side planning (:func:`~repro_torch.core.blocksparse.plan_caps`);
overflow beyond capacity drops blocks (callers assert against ``count``).

:func:`compute_c_structure` and :func:`compute_c_structure_norms` number
the occupied blocks of ``C = A @ B`` from the operands' block occupancy
alone — the one-shot equivalent of the create-from-ids task tree; the
engine's ``validate_structure`` cross-check uses them too.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .blocksparse import (BlockSparse, enumerate_pairs_flat,
                          enumerate_pairs_hier, from_dense, nonzero_padded,
                          slot_map, to_dense)

GemmFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _default_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(p, bs, bs) x (p, bs, bs) batched GEMM through kernels.ops: the CUDA
    kernel on the card, its plain version on the CPU."""
    from repro_torch.kernels import ops as kops
    return kops.batched_gemm(a, b)


def _structure_from_occupancy(mc: torch.Tensor, cap_c: int
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor]:
    """Row-major slot numbering of an occupancy matrix (shared helper).

    Returns ``(crows, ccols, cslot, count)``: the first ``count`` entries
    of ``crows``/``ccols`` are the occupied blocks in row-major order, the
    rest (up to ``cap_c``) are filled with ``g``; ``cslot`` is the
    ``(g + 1, g + 1)`` map from a block to its slot, -1 where empty.
    """
    g = mc.shape[0]
    crows, ccols = nonzero_padded(mc, cap_c, g)
    cslot = slot_map(crows, ccols, g)
    return crows, ccols, cslot, mc.sum().to(torch.int32)


def compute_c_structure(mask_a: torch.Tensor, mask_b: torch.Tensor,
                        cap_c: int) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor, torch.Tensor]:
    """Occupancy of C = A @ B: rows, cols, slot map, count.

    The boolean matmul is the one-shot equivalent of the create-from-ids
    task tree: it tells us which C blocks exist before any flop is spent.
    It runs as a float32 product (exact for the counts of any grid below
    2**24 blocks a side) so that it works on every device.
    """
    mc = (mask_a.float() @ mask_b.float()) > 0
    return _structure_from_occupancy(mc, cap_c)


def compute_c_structure_norms(norm_a: torch.Tensor, norm_b: torch.Tensor,
                              tau: float, cap_c: int
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor]:
    """Norm-weighted occupancy of C = A @ B under SpAMM truncation.

    ``norm_a[i, k]`` / ``norm_b[k, j]`` are per-block Frobenius norms
    (0 for structurally absent blocks).  Block C[i, j] survives iff some
    inner index k satisfies ``norm_a[i, k] * norm_b[k, j] >= tau`` — a
    max-times ("tropical") matmul replacing the boolean one.  ``tau <= 0``
    delegates to the exact :func:`compute_c_structure` on the nonzero
    masks (the ``>= tau`` test would otherwise mark every cell occupied,
    absent blocks included).
    """
    if tau <= 0.0:
        return compute_c_structure(norm_a > 0, norm_b > 0, cap_c)
    best = (norm_a[:, :, None] * norm_b[None, :, :]).amax(dim=1)
    mc = best >= tau
    return _structure_from_occupancy(mc, cap_c)


def bsmm(a: BlockSparse, b: BlockSparse, *,
         pair_caps: Sequence[int], cap_c: int,
         gemm_fn: Optional[GemmFn] = None,
         hierarchical: bool = True,
         use_pair_kernel: bool = False) -> tuple[BlockSparse, dict]:
    """C = A @ B, block-sparse x block-sparse -> block-sparse.

    ``use_pair_kernel=True`` runs the fused gather-GEMM-scatter
    (``kernels.ops.bsmm_pairs``) instead of gather + batched GEMM +
    segment sum.  Returns (C, info); info carries the counts (pairs, c
    blocks) so callers can assert no capacity overflow occurred.
    """
    assert a.grid == b.grid and a.bs == b.bs
    gemm = gemm_fn or _default_gemm

    mask_a, mask_b = a.mask(), b.mask()
    if hierarchical:
        pairs, n_pairs = enumerate_pairs_hier(mask_a, mask_b, pair_caps)
    else:
        pairs, n_pairs = enumerate_pairs_flat(mask_a, mask_b, pair_caps[-1])

    crows, ccols, cslot, n_c = compute_c_structure(mask_a, mask_b, cap_c)

    pi, pk, pj = (pairs[:, x].long() for x in range(3))
    # slot lookups; padding triples (coords == g) resolve to -1
    sa = a.slot[pi, pk]
    sb = b.slot[pk, pj]
    sc = cslot[pi, pj]
    pvalid = (sa >= 0) & (sb >= 0) & (sc >= 0)
    seg = torch.where(pvalid, sc, torch.full_like(sc, cap_c))  # extra bin

    if use_pair_kernel:
        from repro_torch.kernels import ops as kops
        # the kernel needs ascending seg; the reference's argsort is stable
        order = torch.argsort(seg, stable=True)
        c_blocks = kops.bsmm_pairs(
            a.blocks, b.blocks, sa.clamp(min=0)[order],
            sb.clamp(min=0)[order], seg[order], cap_c=cap_c)
    else:
        a_blocks = a.blocks[sa.clamp(min=0).long()]
        b_blocks = b.blocks[sb.clamp(min=0).long()]
        prods = gemm(a_blocks, b_blocks)
        prods = torch.where(pvalid[:, None, None], prods,
                            torch.zeros((), dtype=prods.dtype,
                                        device=prods.device))
        c_blocks = torch.zeros((cap_c + 1,) + prods.shape[1:],
                               dtype=prods.dtype, device=prods.device)
        c_blocks.index_add_(0, seg.long(), prods)
        c_blocks = c_blocks[:cap_c]

    c = BlockSparse(c_blocks.to(a.blocks.dtype), crows, ccols, n_c, cslot)
    return c, {"n_pairs": n_pairs, "n_c_blocks": n_c,
               "pair_cap": pairs.shape[0], "c_cap": cap_c}


def bsmm_dense_ref(a_dense: torch.Tensor, b_dense: torch.Tensor
                   ) -> torch.Tensor:
    """Oracle: plain dense product."""
    return a_dense @ b_dense


def bsmm_from_dense(a_dense: torch.Tensor, b_dense: torch.Tensor, *, bs: int,
                    cap_a: int, cap_b: int, cap_c: int,
                    pair_caps: tuple, hierarchical: bool = True
                    ) -> tuple[torch.Tensor, dict]:
    """Pack -> multiply -> unpack (test/bench convenience)."""
    a = from_dense(a_dense, bs, cap_a)
    b = from_dense(b_dense, bs, cap_b)
    c, info = bsmm(a, b, pair_caps=list(pair_caps), cap_c=cap_c,
                   hierarchical=hierarchical)
    return to_dense(c), info


# ---------------------------------------------------------------------------
# Work accounting (bridges to §5 / Figs 3-4 at the block level)
# ---------------------------------------------------------------------------

def pair_counts_per_level(mask_a: np.ndarray, mask_b: np.ndarray
                          ) -> dict[int, int]:
    """Exact surviving-triple counts per quadtree level for C = A B.

    Level convention matches the paper: 0 = root, L = leaf.  These equal the
    paper's multiplication-task counts when blocksize == leaf size.
    """
    from .blocksparse import _np_pyramid
    pyr_a = _np_pyramid(np.asarray(mask_a))
    pyr_b = _np_pyramid(np.asarray(mask_b))
    L = len(pyr_a) - 1
    out = {}
    for l in range(L + 1):
        a_l = pyr_a[L - l].astype(np.int64)
        b_l = pyr_b[L - l].astype(np.int64)
        out[l] = int((a_l.sum(0) * b_l.sum(1)).sum())
    return out


def useful_flops(mask_a: np.ndarray, mask_b: np.ndarray, bs: int) -> float:
    """2 * bs^3 * (# leaf-level pairs): the flops a perfect engine performs."""
    counts = pair_counts_per_level(mask_a, mask_b)
    return 2.0 * bs ** 3 * counts[max(counts)]
