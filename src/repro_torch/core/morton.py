"""Morton (Z-order) curve utilities.

The quadtree hierarchy of the paper *is* a Morton ordering: the path from the
root to a leaf (choosing one of 4 children at each of L levels) spells out the
bit-interleaved (row, col) address of the leaf block.  We exploit this to turn
the paper's "placement follows the recursion" property into a static,
locality-preserving block layout on a TPU mesh: a contiguous Morton range of
leaf blocks is exactly the leaf set of a quadtree subtree.

Pure numpy on the host (quadtree library, planning) and torch on a
rank's device (the distributed multiply's ownership mask).
"""
from __future__ import annotations

import numpy as np
import torch

_B = [0x5555555555555555, 0x3333333333333333,
      0x0F0F0F0F0F0F0F0F, 0x00FF00FF00FF00FF,
      0x0000FFFF0000FFFF]


def _part1by1(x: np.ndarray) -> np.ndarray:
    """Insert a zero bit between each bit of x (supports values < 2**32)."""
    x = np.asarray(x, dtype=np.uint64)
    x = (x | (x << np.uint64(16))) & np.uint64(_B[4])
    x = (x | (x << np.uint64(8))) & np.uint64(_B[3])
    x = (x | (x << np.uint64(4))) & np.uint64(_B[2])
    x = (x | (x << np.uint64(2))) & np.uint64(_B[1])
    x = (x | (x << np.uint64(1))) & np.uint64(_B[0])
    return x


def _compact1by1(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64) & np.uint64(_B[0])
    x = (x | (x >> np.uint64(1))) & np.uint64(_B[1])
    x = (x | (x >> np.uint64(2))) & np.uint64(_B[2])
    x = (x | (x >> np.uint64(4))) & np.uint64(_B[3])
    x = (x | (x >> np.uint64(8))) & np.uint64(_B[4])
    x = (x | (x >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return x


def encode(row, col) -> np.ndarray:
    """Morton code with row bits at odd positions, col bits at even positions.

    encode(r, c) = interleave(r, c); sorting by the code walks the quadtree
    depth-first (Z shape within every 2x2 at every level).
    """
    return (_part1by1(row) << np.uint64(1)) | _part1by1(col)


def decode(code) -> tuple[np.ndarray, np.ndarray]:
    code = np.asarray(code, dtype=np.uint64)
    return _compact1by1(code >> np.uint64(1)), _compact1by1(code)


def morton_permutation(grid: int) -> np.ndarray:
    """perm[z] = row-major index of the z-th block in Morton order.

    ``grid`` must be a power of two.  Useful to relabel a (grid x grid) block
    matrix so that contiguous ranges = quadtree subtrees.
    """
    assert grid & (grid - 1) == 0, "grid must be a power of two"
    rows = np.repeat(np.arange(grid), grid)
    cols = np.tile(np.arange(grid), grid)
    z = encode(rows, cols).astype(np.int64)
    perm = np.empty(grid * grid, dtype=np.int64)
    perm[z] = np.arange(grid * grid)
    return perm


def owner_of_block(row, col, grid: int, n_devices: int) -> np.ndarray:
    """Device owning leaf block (row, col) under Morton-range distribution.

    The Morton range [0, grid^2) is split into n_devices equal contiguous
    chunks; each chunk is a union of quadtree subtrees (exactly one subtree
    when n_devices is a power of 4).  This reproduces the paper's
    placement-follows-recursion property statically.
    """
    z = encode(row, col).astype(np.int64)
    per = (grid * grid) // n_devices
    return z // per


# ---- torch versions (on a rank's device) ---------------------------------

def _torch_part1by1(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64)
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def torch_encode(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Morton encode of block-index tensors < 2**16 (int64 codes)."""
    return (_torch_part1by1(row) << 1) | _torch_part1by1(col)


def level_of(code: int, leaf_level: int, level: int) -> int:
    """Ancestor Morton code at ``level`` of a leaf code at ``leaf_level``."""
    return code >> (2 * (leaf_level - level))
