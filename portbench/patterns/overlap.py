"""Overlap matrices of electronic structure (arXiv:1501.07800, §6.2).

Particles on a jittered 3-D grid (one basis function each), ordered by
recursive divide-space splits (Ergo's default), with an element wherever
two particles lie closer than the cutoff.  Frozen, vectorised copies of
the program's ``core/patterns.py::particle_cloud``, ``divide_space_order``
and ``overlap_pairs``: the same pattern, computed level by level and
offset by offset instead of by recursion and per-particle slices.

Values: exp(-|x_r - x_c|^2 / 4), the Gaussian overlap, times a symmetric
factor 1 + noise/10 with the noise uniform in [-0.5, 0.5) from the seed,
so that every seed multiplies different numbers on the same pattern.
"""
from __future__ import annotations

from itertools import product

import numpy as np

from pbench.inputs import Pattern, hash01


def particle_cloud(n_per_dim: int, dim: int, spacing: float = 2.0,
                   jitter: float = 1.0, seed: int = 0) -> np.ndarray:
    """Particles on a D-dim grid with uniform random jitter."""
    rng = np.random.default_rng(seed)
    axes = [np.arange(n_per_dim, dtype=np.float64) * spacing] * dim
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, dim)
    return grid + rng.uniform(-jitter, jitter, size=grid.shape)


def divide_space_order(coords: np.ndarray) -> np.ndarray:
    """Recursive divide-space order: split each set in two at the median
    of its widest axis, the first half taking the ``len // 2`` smallest.

    All sets of one level split at once: one sort by (set, coordinate
    along the set's axis).  The halves are the sets the recursive version
    forms with ``argpartition``, so the order is the same wherever no two
    particles of a set share the coordinate it splits on."""
    n = len(coords)
    idx = np.arange(n)
    starts = np.zeros(1, np.int64)
    lens = np.array([n], np.int64)
    while (lens > 1).any():
        split = lens > 1
        seg = np.repeat(np.arange(len(lens)), lens)
        pts = coords[idx]
        lo = np.minimum.reduceat(pts, starts, axis=0)
        hi = np.maximum.reduceat(pts, starts, axis=0)
        axis = np.argmax(hi - lo, axis=1)
        key = pts[np.arange(n), axis[seg]]
        idx = idx[np.lexsort((key, seg))]
        half = lens // 2
        new_starts = np.stack([starts, starts + half], 1)[split].ravel()
        new_lens = np.stack([half, lens - half], 1)[split].ravel()
        keep = ~split
        starts = np.concatenate([new_starts, starts[keep]])
        lens = np.concatenate([new_lens, lens[keep]])
        order = np.argsort(starts, kind="stable")
        starts, lens = starts[order], lens[order]
    return idx


def overlap_pairs(coords: np.ndarray, radius: float, order: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) with ||x_i - x_j|| < radius, by a cell list; indices in
    the ``order`` numbering, in the program's order of output."""
    pts = coords[order]
    _, dim = pts.shape
    lo = pts.min(axis=0)
    cid = np.floor((pts - lo) / max(radius, 1e-12)).astype(np.int64)
    ncell = cid.max(axis=0) + 1
    mult = np.cumprod(np.concatenate([[1], ncell[:-1]]))
    lin = cid @ mult
    by_cell = np.argsort(lin, kind="stable")
    starts = np.searchsorted(lin[by_cell], np.arange(0, int(ncell.prod()) + 1))
    rows_out, cols_out = [], []
    r2 = radius * radius
    for off in np.array(list(product(*[(-1, 0, 1)] * dim)), np.int64):
        nb = cid + off
        ok = np.all((nb >= 0) & (nb < ncell), axis=1)
        nb_lin = nb[ok] @ mult
        src = np.nonzero(ok)[0]
        s, e = starts[nb_lin], starts[nb_lin + 1]
        cnt = e - s
        total = int(cnt.sum())
        if total == 0:
            continue
        rep_src = np.repeat(src, cnt)
        first = np.repeat(np.cumsum(cnt) - cnt, cnt)
        idx = by_cell[np.repeat(s, cnt) + np.arange(total) - first]
        keep = ((pts[rep_src] - pts[idx]) ** 2).sum(axis=1) < r2
        rows_out.append(rep_src[keep])
        cols_out.append(idx[keep])
    return np.concatenate(rows_out), np.concatenate(cols_out)


def make(cfg: dict) -> Pattern:
    coords = particle_cloud(int(cfg["particles_per_axis"]), int(cfg["dim"]),
                            spacing=float(cfg["spacing"]),
                            jitter=float(cfg["jitter"]),
                            seed=int(cfg["pattern_seed"]))
    order = divide_space_order(coords)
    rows, cols = overlap_pairs(coords, float(cfg["cutoff"]), order)
    pts = coords[order]

    def values(seed: int, k: int):
        def value_fn(r, c):
            r, c = np.asarray(r), np.asarray(c)
            gauss = np.exp(-((pts[r] - pts[c]) ** 2).sum(-1) / 4.0)
            noise = hash01(np.minimum(r, c), np.maximum(r, c), seed, k)
            return gauss * (1.0 + 0.1 * noise)
        return value_fn
    return Pattern(n=len(coords), rows=rows, cols=cols, upper=True,
                   values=values)
