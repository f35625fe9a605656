"""The frozen pattern generators: the vectorised versions against plain
ones, and values that depend on the seed and nothing else."""
import numpy as np
import pytest

from pbench.bench import HERE, load_module
from pbench.inputs import hash01

banded = load_module(HERE / "patterns" / "banded.py", "t_banded")
overlap = load_module(HERE / "patterns" / "overlap.py", "t_overlap")


def recursive_order(coords):
    """The recursive divide-space order the vectorised one reproduces."""
    order = []

    def rec(idx):
        if len(idx) <= 1:
            order.extend(idx.tolist())
            return
        pts = coords[idx]
        axis = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        mid = len(idx) // 2
        part = np.argpartition(pts[:, axis], mid - 1)
        rec(idx[part[:mid]])
        rec(idx[part[mid:]])
    rec(np.arange(len(coords)))
    return np.asarray(order)


@pytest.mark.parametrize("npd,dim", [(8, 3), (5, 3), (13, 2)])
def test_divide_space_order_matches_the_recursion(npd, dim):
    c = overlap.particle_cloud(npd, dim, seed=3)
    np.testing.assert_array_equal(overlap.divide_space_order(c),
                                  recursive_order(c))


def test_overlap_pairs_are_every_pair_within_the_cutoff():
    c = overlap.particle_cloud(6, 3, seed=1)
    order = overlap.divide_space_order(c)
    rows, cols = overlap.overlap_pairs(c, 4.5, order)
    pts = c[order]
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    want = set(zip(*np.nonzero(d2 < 4.5 ** 2)))
    got = set(zip(rows.tolist(), cols.tolist()))
    assert got == want and len(rows) == len(got)


def test_banded_pairs_are_the_band():
    rows, cols = banded.banded_pairs(40, 3)
    m = np.zeros((40, 40), bool)
    m[rows, cols] = True
    i = np.arange(40)
    np.testing.assert_array_equal(m, np.abs(i[:, None] - i[None]) <= 3)


def test_values_follow_the_seed_and_value_set():
    r, c = np.array([0, 5, 2 ** 20]), np.array([1, 5, 7])
    a = hash01(r, c, 2 ** 31 + 5, 0)
    np.testing.assert_array_equal(a, hash01(r, c, 2 ** 31 + 5, 0))
    assert (a != hash01(r, c, 2 ** 31 + 6, 0)).all()
    assert (a != hash01(r, c, 2 ** 31 + 5, 1)).all()
    assert (a >= -0.5).all() and (a < 0.5).all()
    cfg = {"particles_per_axis": 4, "dim": 3, "spacing": 2.0, "jitter": 1.0,
           "pattern_seed": 0, "cutoff": 4.5}
    p = overlap.make(cfg)
    v = p.values(9, 0)
    np.testing.assert_array_equal(v(p.rows, p.cols), v(p.cols, p.rows))
