"""Sparsity-pattern generators used throughout the paper's evaluation.

All generators return boolean occupancy matrices over an ``n x n`` element (or
block) grid.  They correspond to the four pattern families in §5/§6:

* ``banded``        — bandwidth 2d+1 (Fig 3 right, Figs 9, 12-14)
* ``random``        — uniform iid density delta (Fig 3 left)
* ``overlap``       — D-dimensional particle clouds with cutoff radius R and
                      recursive divide-space ordering (Fig 4 left, Figs 10-11)
* ``rmat``          — R-MAT graphs with tunable locality parameter a (Fig 4 right)

Element values, when requested, are deterministic given ``seed``.
"""
from __future__ import annotations

import numpy as np


def banded_mask(n: int, d: int) -> np.ndarray:
    """Boolean mask of a banded matrix with bandwidth 2d+1."""
    idx = np.arange(n)
    return np.abs(idx[:, None] - idx[None, :]) <= d


def random_mask(n: int, delta: float, seed: int = 0) -> np.ndarray:
    """Uniform iid sparsity: P[A_ij != 0] = delta, independent everywhere."""
    rng = np.random.default_rng(seed)
    return rng.random((n, n)) < delta


def random_symmetric_mask(n: int, delta: float, seed: int = 0) -> np.ndarray:
    m = random_mask(n, delta, seed)
    return m | m.T


# ---------------------------------------------------------------------------
# Overlap matrices: particles on a jittered D-dimensional grid, one basis
# function per particle, A_ij nonzero iff dist(i, j) < R.  Ordering via the
# recursive divide-space procedure (median splits along the widest axis),
# which is what gives the quadtree its locality (paper §5.1 and Ergo default).
# ---------------------------------------------------------------------------

def particle_cloud(n_per_dim: int, dim: int, spacing: float = 2.0,
                   jitter: float = 1.0, seed: int = 0) -> np.ndarray:
    """Hydrogen-like particles on a D-dim grid with uniform random jitter."""
    rng = np.random.default_rng(seed)
    axes = [np.arange(n_per_dim, dtype=np.float64) * spacing] * dim
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, dim)
    return grid + rng.uniform(-jitter, jitter, size=grid.shape)


def divide_space_order(coords: np.ndarray) -> np.ndarray:
    """Recursive divide-space ordering (paper's/Ergo's default ordering).

    Recursively split the particle set in half by the median coordinate along
    the widest axis of its bounding box.  Returns a permutation of particle
    indices; consecutive indices are spatially close, so near-diagonal matrix
    entries correspond to nearby particles — the source of data locality.
    """
    order: list[int] = []

    def rec(idx: np.ndarray) -> None:
        if len(idx) <= 1:
            order.extend(idx.tolist())
            return
        pts = coords[idx]
        widths = pts.max(axis=0) - pts.min(axis=0)
        axis = int(np.argmax(widths))
        mid = len(idx) // 2
        part = np.argpartition(pts[:, axis], mid - 1)
        rec(idx[part[:mid]])
        rec(idx[part[mid:]])

    rec(np.arange(len(coords)))
    return np.asarray(order, dtype=np.int64)


def overlap_mask(coords: np.ndarray, radius: float,
                 order: np.ndarray | None = None,
                 chunk: int = 2048) -> np.ndarray:
    """A_ij = ||x_i - x_j|| < radius, rows/cols permuted by ``order``."""
    if order is None:
        order = divide_space_order(coords)
    pts = coords[order]
    n = len(pts)
    out = np.zeros((n, n), dtype=bool)
    for s in range(0, n, chunk):  # chunked pairwise distances: O(n^2) memory-safe
        e = min(s + chunk, n)
        d2 = ((pts[s:e, None, :] - pts[None, :, :]) ** 2).sum(-1)
        out[s:e] = d2 < radius * radius
    return out


# ---------------------------------------------------------------------------
# R-MAT (recursive matrix) graphs — locality tunable via the ``a`` parameter.
# a = 0.25 => essentially uniform random; a -> 1 => strongly diagonal/local.
# Paper §5.1: b = c = d = (1 - a) / 3.
# ---------------------------------------------------------------------------

def rmat_mask(scale: int, edges_per_row: float, a: float,
              seed: int = 0, symmetric: bool = False) -> np.ndarray:
    n = 1 << scale
    n_edges = int(edges_per_row * n)
    rng = np.random.default_rng(seed)
    bcd = (1.0 - a) / 3.0
    # quadrant probabilities [ (0,0)=a, (0,1)=b, (1,0)=c, (1,1)=d ]
    probs = np.array([a, bcd, bcd, bcd])
    # vectorised: draw quadrant choices for all edges x all bit levels at once
    choices = rng.choice(4, size=(n_edges, scale), p=probs)
    row_bits = (choices >> 1) & 1
    col_bits = choices & 1
    weights = (1 << np.arange(scale - 1, -1, -1)).astype(np.int64)
    rows = (row_bits * weights).sum(axis=1)
    cols = (col_bits * weights).sum(axis=1)
    m = np.zeros((n, n), dtype=bool)
    m[rows, cols] = True  # duplicate edges collapse, as in the paper
    if symmetric:
        m |= m.T
    return m


# ---------------------------------------------------------------------------
# Values for masks (deterministic, well-conditioned for correctness tests).
# ---------------------------------------------------------------------------

def values_for_mask(mask: np.ndarray, seed: int = 0,
                    symmetric: bool = False,
                    dtype=np.float64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(mask.shape).astype(dtype)
    if symmetric:
        a = (a + a.T) / 2.0
        m = np.asarray(mask) | np.asarray(mask).T
    else:
        m = np.asarray(mask)
    return np.where(m, a, 0.0).astype(dtype)


def block_mask_from_element_mask(mask: np.ndarray, bs: int) -> np.ndarray:
    """Occupancy of bs x bs blocks given an element-level mask (n divisible by bs)."""
    n = mask.shape[0]
    g = n // bs
    return mask.reshape(g, bs, g, bs).any(axis=(1, 3))


# ---------------------------------------------------------------------------
# Sparse (coordinate-list) variants — needed at paper scale (n = 65536+ in
# Fig 4) where dense boolean masks would take O(n^2) memory.
# ---------------------------------------------------------------------------

def banded_pairs(n: int, d: int) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) of the nonzeros of a banded matrix, bandwidth 2d+1."""
    rows = np.repeat(np.arange(n), 2 * d + 1)
    cols = rows + np.tile(np.arange(-d, d + 1), n)
    ok = (cols >= 0) & (cols < n)
    return rows[ok], cols[ok]


def overlap_pairs(coords: np.ndarray, radius: float,
                  order: np.ndarray | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) with ||x_i - x_j|| < radius via cell-list neighbour search.

    O(n * 3^D * avg_cell_occupancy) instead of O(n^2); rows/cols are indices
    in the (divide-space) ordered numbering.
    """
    if order is None:
        order = divide_space_order(coords)
    pts = coords[order]
    n, dim = pts.shape
    lo = pts.min(axis=0)
    cell = np.maximum(radius, 1e-12)
    cid = np.floor((pts - lo) / cell).astype(np.int64)
    ncell = cid.max(axis=0) + 1
    # linearise cell ids
    mult = np.cumprod(np.concatenate([[1], ncell[:-1]]))
    lin = cid @ mult
    order_by_cell = np.argsort(lin, kind="stable")
    lin_sorted = lin[order_by_cell]
    starts = np.searchsorted(lin_sorted, np.arange(0, int(ncell.prod()) + 1))
    # neighbour cell offsets
    from itertools import product as _prod
    offs = np.array(list(_prod(*[(-1, 0, 1)] * dim)), dtype=np.int64)
    rows_out: list[np.ndarray] = []
    cols_out: list[np.ndarray] = []
    r2 = radius * radius
    for off in offs:
        nb = cid + off
        ok = np.all((nb >= 0) & (nb < ncell), axis=1)
        nb_lin = nb[ok] @ mult
        src = np.nonzero(ok)[0]
        # for each source particle, candidate targets = particles in cell nb_lin
        s, e = starts[nb_lin], starts[nb_lin + 1]
        cnt = e - s
        if cnt.sum() == 0:
            continue
        rep_src = np.repeat(src, cnt)
        # gather candidate indices
        idx = np.concatenate([order_by_cell[a:b] for a, b in zip(s, e)]) \
            if len(s) else np.empty(0, np.int64)
        d2 = ((pts[rep_src] - pts[idx]) ** 2).sum(axis=1)
        keep = d2 < r2
        rows_out.append(rep_src[keep])
        cols_out.append(idx[keep])
    rows = np.concatenate(rows_out) if rows_out else np.empty(0, np.int64)
    cols = np.concatenate(cols_out) if cols_out else np.empty(0, np.int64)
    return rows, cols


def rmat_pairs(scale: int, edges_per_row: float, a: float, seed: int = 0,
               symmetric: bool = False) -> tuple[np.ndarray, np.ndarray]:
    n = 1 << scale
    n_edges = int(edges_per_row * n)
    rng = np.random.default_rng(seed)
    bcd = (1.0 - a) / 3.0
    probs = np.array([a, bcd, bcd, bcd])
    choices = rng.choice(4, size=(n_edges, scale), p=probs)
    weights = (1 << np.arange(scale - 1, -1, -1)).astype(np.int64)
    rows = (((choices >> 1) & 1) * weights).sum(axis=1)
    cols = ((choices & 1) * weights).sum(axis=1)
    uniq = np.unique(rows * n + cols)
    rows, cols = uniq // n, uniq % n
    if symmetric:
        allr = np.concatenate([rows, cols])
        allc = np.concatenate([cols, rows])
        uniq = np.unique(allr * n + allc)
        rows, cols = uniq // n, uniq % n
    return rows, cols


def coarsen_pairs(rows: np.ndarray, cols: np.ndarray, factor: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Occupancy coordinates one-or-more quadtree levels up (dedup)."""
    n_max = int(max(rows.max(initial=0), cols.max(initial=0))) + 1
    g = (n_max + factor - 1) // factor
    r, c = rows // factor, cols // factor
    uniq = np.unique(r * g + c)
    return uniq // g, uniq % g
