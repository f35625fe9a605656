"""Banded matrices (arXiv:1501.07800's banded test matrices).

A frozen copy of the program's ``core/patterns.py::banded_pairs``, so that
a change there cannot move the inputs.  Values are uniform in
[-0.5, 0.5), drawn per element from the seed.
"""
from __future__ import annotations

import numpy as np

from pbench.inputs import Pattern, hash01


def banded_pairs(n: int, d: int) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) of the nonzeros of a banded matrix, bandwidth 2d+1."""
    rows = np.repeat(np.arange(n), 2 * d + 1)
    cols = rows + np.tile(np.arange(-d, d + 1), n)
    ok = (cols >= 0) & (cols < n)
    return rows[ok], cols[ok]


def make(cfg: dict) -> Pattern:
    n, d = int(cfg["n"]), int(cfg["half_bandwidth"])
    rows, cols = banded_pairs(n, d)

    def values(seed: int, k: int):
        return lambda r, c: hash01(r, c, seed, k)
    return Pattern(n=n, rows=rows, cols=cols, upper=False, values=values)
