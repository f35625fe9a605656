"""Density-matrix stand-ins for SP2 purification with SpAMM truncation.

The overlap cloud of ``overlap.py`` (arXiv:1501.07800, §6.2): the same
particles on a jittered 3-D grid, the same divide-space order and the
same elements, wherever two particles lie closer than the cutoff (its
functions, imported).  A density matrix of an insulator decays
exponentially with distance, so the values are exp(-|x_r - x_c| /
decay_length), times the symmetric factor 1 + noise/10 of ``overlap.py``
(the noise uniform in [-0.5, 0.5) from the seed).  Storage is full, not
symmetric upper: the program truncates a multiply of plain operands only.
"""
from __future__ import annotations

import pathlib

import numpy as np

from pbench.bench import load_module
from pbench.inputs import Pattern, hash01

overlap = load_module(pathlib.Path(__file__).with_name("overlap.py"),
                      "portbench_pattern_overlap")


def make(cfg: dict) -> Pattern:
    coords = overlap.particle_cloud(int(cfg["particles_per_axis"]),
                                    int(cfg["dim"]),
                                    spacing=float(cfg["spacing"]),
                                    jitter=float(cfg["jitter"]),
                                    seed=int(cfg["pattern_seed"]))
    order = overlap.divide_space_order(coords)
    rows, cols = overlap.overlap_pairs(coords, float(cfg["cutoff"]), order)
    pts = coords[order]
    length = float(cfg["decay_length"])

    def values(seed: int, k: int):
        def value_fn(r, c):
            r, c = np.asarray(r), np.asarray(c)
            dist = np.sqrt(((pts[r] - pts[c]) ** 2).sum(-1))
            noise = hash01(np.minimum(r, c), np.maximum(r, c), seed, k)
            return np.exp(-dist / length) * (1.0 + 0.1 * noise)
        return value_fn
    return Pattern(n=len(coords), rows=rows, cols=cols, upper=False,
                   values=values)
