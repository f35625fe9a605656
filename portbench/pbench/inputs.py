"""Inputs of a cell: a fixed nonzero pattern and values drawn from the seed.

The pattern is a function of the configuration alone; the values of
every matrix are a function of ``(seed, k, row, col)``, where ``k``
numbers the matrices a cell builds (its value sets).  Values are computed
element by element from a 64-bit hash, so the program's construction and
the reference read the same number for the same element without either
holding a dense matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

_M64 = 2 ** 64


def hash01(rows, cols, seed: int, k: int) -> np.ndarray:
    """Deterministic values in [-0.5, 0.5) per (row, col) for ``(seed, k)``
    (splitmix64's finaliser over a mix of the four).  ``seed`` may be any
    integer; it is reduced modulo 2**64."""
    salt = np.uint64((int(seed) * 0x94D049BB133111EB
                      + (int(k) + 1) * 0xD6E8FEB86659FD93) % _M64)
    x = (np.asarray(rows, np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         + np.asarray(cols, np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
         + salt)
    x ^= x >> np.uint64(31)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(29)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(32)
    return (x >> np.uint64(11)).astype(np.float64) / 2.0 ** 53 - 0.5


@dataclasses.dataclass
class Pattern:
    """A matrix pattern: ``n``, the nonzeros' coordinates (both triangles
    for a symmetric matrix), whether the program stores it as symmetric
    upper, and ``values(seed, k)``: the element value function of value
    set ``k``, vectorised over index arrays (float64)."""
    n: int
    rows: np.ndarray
    cols: np.ndarray
    upper: bool
    values: Callable[[int, int], Callable[[np.ndarray, np.ndarray],
                                          np.ndarray]]
