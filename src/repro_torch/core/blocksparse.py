"""Static-capacity block-sparse matrix format (torch).

The port of ``repro/core/blocksparse.py``, the rendering of the paper's
quadtree matrix chunk (§3.1) as packed tensors:

* a **packed block array** holds only nonzero ``bs x bs`` blocks, with a
  *capacity* ``cap``; occupancy is detected from the data at run time
  (``torch.nonzero`` padded and cut to ``cap`` in row-major order, the
  reference's ``jnp.nonzero(size=cap)``), which keeps the paper's "no
  a-priori knowledge, no symbolic step" property;
* a **slot map** ``slot[i, k] -> packed index`` replaces the
  chunk-identifier indirection of the Chunks and Tasks runtime;
* the **mask pyramid** (:func:`mask_pyramid`) is the quadtree itself:
  boolean occupancy at every level, level 0 = root.  NIL chunk identifiers
  at any level (paper §3.1) == False entries at any pyramid level.

Shapes depend only on ``(n, bs, cap)``, as in the reference; every tensor
stays on the device of its input.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class BlockSparse:
    """Packed block-sparse matrix with static capacity.

    blocks : (cap, bs, bs)  packed nonzero blocks (padding slots are zero)
    rows   : (cap,) int32   block-row of each slot; ``grid`` marks padding
    cols   : (cap,) int32   block-col of each slot; ``grid`` marks padding
    nnzb   : () int32       number of occupied blocks (may exceed cap)
    slot   : (grid+1, grid+1) int32  packed index of block (i,k); -1 = empty.
             The extra row/col absorbs padding coordinates.
    """
    blocks: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    nnzb: torch.Tensor
    slot: torch.Tensor

    @property
    def cap(self) -> int:
        return self.blocks.shape[0]

    @property
    def bs(self) -> int:
        return self.blocks.shape[1]

    @property
    def grid(self) -> int:
        return self.slot.shape[0] - 1

    @property
    def n(self) -> int:
        return self.grid * self.bs

    def mask(self) -> torch.Tensor:
        """(grid, grid) bool occupancy — quadtree leaf level."""
        return self.slot[:-1, :-1] >= 0

    def valid(self) -> torch.Tensor:
        """(cap,) bool — which packed slots hold real blocks."""
        return self.rows < self.grid


def nonzero_padded(mask: torch.Tensor, size: int, fill: int
                   ) -> tuple[torch.Tensor, ...]:
    """``jnp.nonzero(mask, size=size, fill_value=fill)``: the indices of
    the set entries in row-major order, cut to ``size`` and padded with
    ``fill``; one int32 tensor per dimension."""
    nz = torch.nonzero(mask)[:size].to(torch.int32)
    out = torch.full((size, mask.dim()), fill, dtype=torch.int32,
                     device=mask.device)
    out[:len(nz)] = nz
    return tuple(out[:, d] for d in range(mask.dim()))


def slot_map(rows: torch.Tensor, cols: torch.Tensor, grid: int
             ) -> torch.Tensor:
    """(grid+1, grid+1) int32 map of ``(rows[s], cols[s]) -> s``; -1 where
    no slot is, and on the padding row and column ``grid``."""
    slot = torch.full((grid + 1, grid + 1), -1, dtype=torch.int32,
                      device=rows.device)
    slot[rows.long(), cols.long()] = torch.arange(
        rows.shape[0], dtype=torch.int32, device=rows.device)
    slot[grid, :] = -1
    slot[:, grid] = -1
    return slot


def from_dense(a: torch.Tensor, bs: int, cap: int) -> BlockSparse:
    """Detect occupancy and pack nonzero blocks.

    Zero blocks are detected from the data — the analogue of the library
    "dynamically detecting" sparsity (paper abstract).
    """
    n = a.shape[0]
    assert a.shape == (n, n) and n % bs == 0
    g = n // bs
    tiles = a.reshape(g, bs, g, bs).permute(0, 2, 1, 3)
    occ = (tiles != 0).any(dim=3).any(dim=2)
    rows, cols = nonzero_padded(occ, cap, g)
    nnzb = occ.sum().to(torch.int32)
    valid = rows < g
    data = tiles[rows.clamp(max=g - 1).long(), cols.clamp(max=g - 1).long()]
    data = torch.where(valid[:, None, None], data, torch.zeros((), dtype=a.dtype,
                                                               device=a.device))
    return BlockSparse(data.contiguous(), rows, cols, nnzb,
                       slot_map(rows, cols, g))


def from_blocks(rows: np.ndarray, cols: np.ndarray, blocks: torch.Tensor,
                grid: int, cap: int) -> BlockSparse:
    """Pack an explicit (rows, cols, blocks) triplet list (host-side setup)."""
    k = len(rows)
    assert k <= cap, f"{k} blocks exceed capacity {cap}"
    bs = blocks.shape[-1]
    dev = blocks.device
    data = torch.zeros((cap, bs, bs), dtype=blocks.dtype, device=dev)
    data[:k] = blocks
    r = torch.full((cap,), grid, dtype=torch.int32, device=dev)
    c = torch.full((cap,), grid, dtype=torch.int32, device=dev)
    r[:k] = torch.as_tensor(np.asarray(rows), dtype=torch.int32, device=dev)
    c[:k] = torch.as_tensor(np.asarray(cols), dtype=torch.int32, device=dev)
    return BlockSparse(data, r, c, torch.tensor(k, dtype=torch.int32),
                       slot_map(r, c, grid))


def to_dense(m: BlockSparse) -> torch.Tensor:
    g, bs = m.grid, m.bs
    tiles = torch.zeros((g + 1, g + 1, bs, bs), dtype=m.blocks.dtype,
                        device=m.blocks.device)
    tiles.index_put_((m.rows.long(), m.cols.long()), m.blocks,
                     accumulate=True)
    return tiles[:g, :g].permute(0, 2, 1, 3).reshape(g * bs, g * bs)


def mask_pyramid(mask: torch.Tensor) -> list[torch.Tensor]:
    """Quadtree occupancy masks, finest (leaf) first, 1x1 root last.

    ``pyramid[0]`` is the (grid, grid) leaf mask; each coarser level ORs 2x2
    children — a NIL submatrix at level l == False at pyramid[L - l].
    """
    g = mask.shape[0]
    assert g & (g - 1) == 0, "grid must be a power of two"
    out = [mask]
    while g > 1:
        g //= 2
        mask = mask.reshape(g, 2, g, 2).any(dim=3).any(dim=1)
        out.append(mask)
    return out


# ---------------------------------------------------------------------------
# Pair enumeration — Algorithm 1 rendered statically.
#
# The recursive task expansion of Algorithm 1 ("for m, n, k in {1,2}: register
# multiply(A_mk, B_kn)") becomes a level-by-level expansion of surviving
# (i, k, j) triples: each triple at grid G has 8 children at grid 2G, and a
# child survives iff A's and B's occupancy masks at that level are both
# nonzero — exactly the NIL check on line 2 of Algorithm 1.  The number of
# surviving triples per level is the paper's "number of multiplication tasks
# at level l" (eq. (1)/(8)), so enumeration work is proportional to the
# paper's task count, not to grid^3.
# ---------------------------------------------------------------------------

_CHILD_OFFSETS = np.array(
    [[di, dk, dj] for di in (0, 1) for dk in (0, 1) for dj in (0, 1)],
    dtype=np.int32)  # (8, 3)


def enumerate_pairs_hier(mask_a: torch.Tensor, mask_b: torch.Tensor,
                         caps: Sequence[int],
                         mask_c: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hierarchically enumerate (i, k, j) with A[i,k] and B[k,j] nonzero.

    caps[l] bounds the number of surviving triples at level l+1 (level 0 is
    the 1x1 root, always 1 triple).  Returns (pairs, count): pairs is
    (caps[-1], 3) int32 with padding rows equal to ``grid`` (out of range),
    count the number of valid triples.

    ``mask_c``, when given, additionally requires the *output* cell (i, j)
    to be set at every level — used by the distributed multiply to restrict
    enumeration to the C blocks a rank owns (the quadtree analogue of
    "only compute your own submatrix products").

    Capacity overflow drops triples deterministically (the first ``cap`` in
    row-major order are kept) — callers size caps from the §5 bounds or via
    :func:`plan_caps`.
    """
    g = mask_a.shape[0]
    dev = mask_a.device
    levels = int(np.log2(g))
    assert len(caps) == levels, f"need {levels} caps, got {len(caps)}"
    pyr_a = mask_pyramid(mask_a)   # [leaf ... root]
    pyr_b = mask_pyramid(mask_b)
    pyr_c = mask_pyramid(mask_c) if mask_c is not None else None

    pairs = torch.zeros((1, 3), dtype=torch.int32, device=dev)  # the root
    alive = pyr_a[-1][0, 0] & pyr_b[-1][0, 0]
    count = alive.to(torch.int32)
    offs = torch.as_tensor(_CHILD_OFFSETS, device=dev)

    for l in range(levels):
        ma = pyr_a[levels - 1 - l]    # mask at the children's level
        mb = pyr_b[levels - 1 - l]
        gl = ma.shape[0]
        cap_prev = pairs.shape[0]
        parent_valid = torch.arange(cap_prev, device=dev) < count
        children = pairs[:, None, :] * 2 + offs[None, :, :]
        flat = children.reshape(-1, 3)
        i, k, j = flat[:, 0], flat[:, 1], flat[:, 2]
        inb = (i < gl) & (k < gl) & (j < gl)
        ic, kc, jc = (i.clamp(max=gl - 1).long(), k.clamp(max=gl - 1).long(),
                      j.clamp(max=gl - 1).long())
        ok = (inb & ma[ic, kc] & mb[kc, jc]
              & parent_valid.repeat_interleave(8))
        if pyr_c is not None:
            ok = ok & pyr_c[levels - 1 - l][ic, jc]
        (idx,) = nonzero_padded(ok, caps[l], flat.shape[0])
        count = ok.sum().to(torch.int32)
        padded = torch.cat(
            [flat, torch.full((1, 3), 2 * gl, dtype=torch.int32,
                              device=dev)], dim=0)
        pairs = padded[idx.clamp(max=flat.shape[0]).long()]
        # clamp padding coordinates into "out of range" marker gl
        keep = (torch.arange(caps[l], device=dev) < count)[:, None]
        pairs = torch.where(keep, pairs, torch.full_like(pairs, gl))
    return pairs, count


def enumerate_pairs_flat(mask_a: torch.Tensor, mask_b: torch.Tensor,
                         cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """O(grid^3) reference enumeration (the 'no locality exploitation'
    baseline — what a SUMMA-style static schedule effectively pays)."""
    g = mask_a.shape[0]
    m3 = mask_a[:, :, None] & mask_b[None, :, :]      # (i, k, j)
    i, k, j = nonzero_padded(m3, cap, g)
    return torch.stack([i, k, j], dim=1), m3.sum().to(torch.int32)


def plan_caps(mask_a: np.ndarray, mask_b: np.ndarray,
              slack: float = 1.25, round_to: int = 64) -> list[int]:
    """Host-side capacity schedule: exact per-level surviving-triple counts
    (the paper's task counts, Figs 3-4) with head-room.  Runs on concrete
    masks before the multiply; the multiply is shaped by these caps."""
    g = mask_a.shape[0]
    levels = int(np.log2(g))
    ma, mb = np.asarray(mask_a), np.asarray(mask_b)
    caps = []
    pyr_a, pyr_b = _np_pyramid(ma), _np_pyramid(mb)
    for l in range(levels):
        a_l = pyr_a[levels - 1 - l].astype(np.int64)
        b_l = pyr_b[levels - 1 - l].astype(np.int64)
        cnt = int((a_l.sum(0) * b_l.sum(1)).sum())  # sum_k colA_k * rowB_k
        cap = max(round_to, int(np.ceil(cnt * slack / round_to)) * round_to)
        caps.append(cap)
    return caps


def _np_pyramid(mask: np.ndarray) -> list[np.ndarray]:
    out = [mask]
    g = mask.shape[0]
    while g > 1:
        g //= 2
        mask = mask.reshape(g, 2, g, 2).any(axis=(1, 3))
        out.append(mask)
    return out


def plan_c_cap(mask_a: np.ndarray, mask_b: np.ndarray,
               slack: float = 1.25, round_to: int = 64) -> int:
    """Host-side capacity for the C occupancy (mask_a @ mask_b)."""
    prod = (np.asarray(mask_a, np.int64) @ np.asarray(mask_b, np.int64)) > 0
    cnt = int(prod.sum())
    return max(round_to, int(np.ceil(cnt * slack / round_to)) * round_to)
