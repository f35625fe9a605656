"""Sparse SUMMA baseline (Buluc & Gilbert [46]) on a process grid of ranks.

The port of ``repro/core/spsumma.py``, the comparison target of the paper
(Table 1, Figs 12-14): a static 2D sqrt(p) x sqrt(p) decomposition where
each rank owns one panel of A, B and C; stage-free formulation via
all-gather of the A row-slab along the process-grid columns and the B
col-slab along the rows, then a local sparse multiply.  Communication per
rank is the whole row/col slab: (sqrt(p)-1)/sqrt(p) * (|A_row| + |B_col|)
bytes — eq (15)'s 2mN/sqrt(p) elements — growing as sqrt(p) in weak
scaling, with or without data locality in the pattern.

The planning is the reference's numpy.  :func:`summa_spmm` is a per-rank
function on a ``("pr", "pc")`` mesh (``launch.mesh.make_summa_mesh``):
the all-gathers run on its row and column subgroups.  Counted bytes
follow the reference's HLO convention: the *result* bytes of each
all-gather, the rank's own shard included, i.e.
``2 * pgrid * cap_panel * (4 bs^2 + 8)`` per rank for float32 blocks and
int32 rows and cols.

An optional host-side **random permutation** of block rows/cols mimics the
load-balancing maneuver of [21, 22] that the paper argues *destroys*
locality (Fig 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .blocksparse import nonzero_padded, slot_map
from .distributed import _count, all_gather, group_of, rank_and_size


def summa_pgrid(p: int) -> int:
    """sqrt(p), validated: SpSUMMA runs on a square process grid.

    A non-square device count used to fall through ``int(np.sqrt(p))``
    and silently shard onto a smaller sub-grid (p=6 -> 2x2, two devices
    idle and every measured slab-byte count wrong).  Fail fast instead.
    """
    p = int(p)
    if p < 1:
        raise ValueError(f"SpSUMMA needs at least one device, got p={p}")
    pgrid = int(round(p ** 0.5))
    if pgrid * pgrid != p:
        raise ValueError(
            f"SpSUMMA needs a perfect-square device count for its "
            f"sqrt(p) x sqrt(p) process grid; got p={p}. Use p in "
            f"{{1, 4, 9, 16, ...}} or the parent-worker mesh engine "
            f"(Session(engine='mesh')), which accepts any device count.")
    return pgrid


@dataclasses.dataclass(frozen=True)
class SummaPlan:
    grid: int              # global block grid
    bs: int
    pgrid: int             # process grid is pgrid x pgrid
    cap_panel: int         # max nonzero blocks in any owned panel
    cap_c_panel: int
    cap_pairs: int         # local multiply pair capacity

    @property
    def n_dev(self) -> int:
        return self.pgrid ** 2

    @property
    def panel(self) -> int:        # blocks per panel side
        return self.grid // self.pgrid


def plan_summa(mask_a: np.ndarray, mask_b: np.ndarray, bs: int,
               pgrid: int, slack: float = 1.3, round_to: int = 8
               ) -> SummaPlan:
    grid = mask_a.shape[0]
    summa_pgrid(pgrid * pgrid)      # pgrid must be a positive integer
    if grid % pgrid != 0:
        raise ValueError(
            f"SpSUMMA panel split needs the block grid ({grid}) to be "
            f"divisible by pgrid ({pgrid}); pad the matrix or pick a "
            f"device count whose sqrt divides the grid.")
    panel = grid // pgrid
    ma, mb = np.asarray(mask_a), np.asarray(mask_b)
    mc = (ma.astype(np.int64) @ mb.astype(np.int64)) > 0

    def _panels(m):
        return m.reshape(pgrid, panel, pgrid, panel).sum(axis=(1, 3))

    def _cap(x):
        return max(round_to, int(np.ceil(x * slack / round_to)) * round_to)

    cap_panel = _cap(int(max(_panels(ma).max(), _panels(mb).max())))
    cap_c_panel = _cap(int(_panels(mc).max()))
    # local pairs: row-slab of A x col-slab of B restricted to own panel
    worst = 0
    for r in range(pgrid):
        for c in range(pgrid):
            a_slab = ma[r * panel:(r + 1) * panel, :].astype(np.int64)
            b_slab = mb[:, c * panel:(c + 1) * panel].astype(np.int64)
            worst = max(worst, int((a_slab.sum(0) * b_slab.sum(1)).sum()))
    cap_pairs = _cap(worst)
    return SummaPlan(grid=grid, bs=bs, pgrid=pgrid, cap_panel=cap_panel,
                     cap_c_panel=cap_c_panel, cap_pairs=cap_pairs)


def random_block_permutation(grid: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).permutation(grid)


def distribute_panels(dense: np.ndarray, bs: int, plan: SummaPlan,
                      perm: Optional[np.ndarray] = None
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a dense matrix into (n_dev, cap_panel, bs, bs) 2D-panel shards.

    Coordinates are *global* block indices (after the optional random
    permutation), padding == grid.  Device order is row-major over the
    process grid.
    """
    grid, pgrid, panel, cap = plan.grid, plan.pgrid, plan.panel, \
        plan.cap_panel
    if perm is not None:
        gp = np.repeat(perm, bs) * bs + np.tile(np.arange(bs), grid)
        dense = dense[np.ix_(gp, gp)]
    tiles = dense.reshape(grid, bs, grid, bs).transpose(0, 2, 1, 3)
    occ = np.abs(tiles).max(axis=(2, 3)) > 0
    n_dev = plan.n_dev
    blocks = np.zeros((n_dev, cap, bs, bs), dense.dtype)
    rows = np.full((n_dev, cap), grid, np.int32)
    cols = np.full((n_dev, cap), grid, np.int32)
    fill = np.zeros(n_dev, np.int64)
    for i, j in zip(*np.nonzero(occ)):
        d = (i // panel) * pgrid + (j // panel)
        s = fill[d]
        assert s < cap
        blocks[d, s] = tiles[i, j]
        rows[d, s] = i
        cols[d, s] = j
        fill[d] += 1
    return blocks, rows, cols


def summa_spmm(mesh, axes: tuple[str, str], plan: SummaPlan,
               a_blocks, a_rows, a_cols, b_blocks, b_rows, b_cols,
               comm: Optional[dict] = None):
    """C = A @ B via SpSUMMA all-gathers on a (pr, pc) process grid.

    Every rank calls it with its own panel shard (:func:`distribute_panels`
    row ``pr * pgrid + pc``), on the device the multiply runs on.  Returns
    this rank's (c_blocks, c_rows, c_cols, n_pairs).  ``mesh=None`` is a
    1 x 1 grid (a world of one).  ``comm`` (a dict) accumulates the
    all-gathers' result bytes under ``"collective_bytes"``.
    """
    g, bs, pgrid = plan.grid, plan.bs, plan.pgrid
    cap_c, cap_pairs = plan.cap_c_panel, plan.cap_pairs
    ax_r, ax_c = axes
    row_group, col_group = group_of(mesh, ax_c), group_of(mesh, ax_r)
    if mesh is None:
        pr = pc = 0
        if rank_and_size(None)[1] != 1 or pgrid != 1:
            raise ValueError("summa_spmm: pass the (pr, pc) mesh of "
                             "make_summa_mesh for more than one rank")
    else:
        pr, pc = mesh.get_local_rank(ax_r), mesh.get_local_rank(ax_c)
        if mesh.size() != plan.n_dev:
            raise ValueError(f"summa_spmm: the plan is for {plan.n_dev} "
                             f"ranks but the mesh has {mesh.size()}")

    # the SpSUMMA communication: row-slab of A, col-slab of B
    A = all_gather(row_group, a_blocks).reshape(-1, bs, bs)
    Ar = all_gather(row_group, a_rows).reshape(-1)
    Ac = all_gather(row_group, a_cols).reshape(-1)
    B = all_gather(col_group, b_blocks).reshape(-1, bs, bs)
    Br = all_gather(col_group, b_rows).reshape(-1)
    Bc = all_gather(col_group, b_cols).reshape(-1)
    _count(comm, A, Ar, Ac, B, Br, Bc)

    slot_a = slot_map(Ar, Ac, g)
    slot_b = slot_map(Br, Bc, g)
    mask_a = slot_a[:g, :g] >= 0
    mask_b = slot_b[:g, :g] >= 0

    panel = g // pgrid
    idx = torch.arange(g, device=A.device) // panel
    owned = (idx[:, None] == pr) & (idx[None, :] == pc)
    mask_c = ((mask_a.float() @ mask_b.float()) > 0) & owned

    crows, ccols = nonzero_padded(mask_c, cap_c, g)
    cslot = slot_map(crows, ccols, g)

    m3 = mask_a[:, :, None] & mask_b[None, :, :] & mask_c[:, None, :]
    pi, pk, pj = (x.long() for x in nonzero_padded(m3, cap_pairs, g))
    n_pairs = m3.sum().to(torch.int32)
    sa, sb, sc = slot_a[pi, pk], slot_b[pk, pj], cslot[pi, pj]
    pvalid = (sa >= 0) & (sb >= 0) & (sc >= 0)
    prods = torch.einsum("pik,pkj->pij", A[sa.clamp(min=0).long()].float(),
                         B[sb.clamp(min=0).long()].float()).to(A.dtype)
    prods = torch.where(pvalid[:, None, None], prods,
                        torch.zeros((), dtype=A.dtype, device=A.device))
    seg = torch.where(pvalid, sc, torch.full_like(sc, cap_c))
    cb = torch.zeros((cap_c + 1, bs, bs), dtype=A.dtype, device=A.device)
    cb.index_add_(0, seg.long(), prods)
    return cb[:cap_c], crows, ccols, n_pairs
