"""The plain reference product and the comparison against hand-built
products."""
import json

import numpy as np
import pytest
import torch
from conftest import BENCH

from pbench import reference as R


def dense_of(rows, cols, vals, n):
    a = np.zeros((n, n))
    a[rows, cols] = vals
    return a


def random_coo(rng, n, density):
    m = rng.random((n, n)) < density
    rows, cols = np.nonzero(m)
    return rows, cols, rng.uniform(-1, 1, len(rows))


@pytest.mark.parametrize("upper", [False, True])
def test_reference_equals_the_dense_product(upper):
    rng = np.random.default_rng(0)
    n, bs = 64, 8
    ra, ca, va = random_coo(rng, n, 0.05)
    rb, cb, vb = random_coo(rng, n, 0.05)
    a = R.block_matrix(ra, ca, va, n, bs)
    b = R.block_matrix(rb, cb, vb, n, bs)
    p = R.reference_product(a, b, upper)
    da, db = dense_of(ra, ca, va, n), dense_of(rb, cb, vb, n)
    want = da @ db
    got = R.as_blocks(p)
    ma = (np.abs(da) > 0).reshape(8, bs, 8, bs).any((1, 3))
    mb = (np.abs(db) > 0).reshape(8, bs, 8, bs).any((1, 3))
    mc = (ma.astype(int) @ mb.astype(int)) > 0
    keys = {(i, j) for i, j in zip(*np.nonzero(mc)) if not upper or i <= j}
    assert set(got) == keys
    for (i, j), blk in got.items():
        np.testing.assert_allclose(
            blk, want[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs], atol=1e-12)
    scale = np.abs(da) @ np.abs(db)
    for t, (i, j) in enumerate(p.keys):
        np.testing.assert_allclose(
            p.scale[t].numpy(),
            scale[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs], atol=1e-12)
    brute = sum(1 for (i, k) in map(tuple, a.keys) for (k2, j) in
                map(tuple, b.keys) if k == k2 and (not upper or i <= j))
    assert p.pairs == brute


def test_hand_built_two_block_product():
    # A = [[1, 0], [0, 2]] in 1x1 blocks of a 2x2 grid, B = [[3, 4], [0, 5]]
    a = R.block_matrix([0, 1], [0, 1], [1.0, 2.0], 2, 1)
    b = R.block_matrix([0, 0, 1], [0, 1, 1], [3.0, 4.0, 5.0], 2, 1)
    got = R.as_blocks(R.reference_product(a, b, False))
    assert {k: float(v[0, 0]) for k, v in got.items()} == {
        (0, 0): 3.0, (0, 1): 4.0, (1, 1): 10.0}


def test_compare_finds_wrong_missing_and_extra_blocks():
    rng = np.random.default_rng(1)
    a = R.block_matrix(*random_coo(rng, 32, 0.1), 32, 8)
    p = R.reference_product(a, a, False)
    exact = R.as_blocks(p)
    assert R.compare(exact, p) == {"c_blocks_wrong": 0, "max_rel_err": 0.0}
    k0 = next(iter(exact))
    missing = dict(exact)
    del missing[k0]
    assert R.compare(missing, p)["c_blocks_wrong"] == 1
    extra = dict(exact)
    extra[(99, 99)] = np.zeros((8, 8))
    assert R.compare(extra, p)["c_blocks_wrong"] == 1
    off = {k: v.copy() for k, v in exact.items()}
    off[k0][0, 0] += 1e-3 * float(p.scale[0, 0, 0]) + 1e-3
    assert R.compare(off, p)["max_rel_err"] > 1e-5
    nan = {k: v.copy() for k, v in exact.items()}
    nan[k0][1, 1] = np.nan
    assert R.compare(nan, p)["max_rel_err"] == 1e30


def _operands(pat, op, bs, seed, dtype=np.float64):
    """Each operand of ``op`` as its value set of the pattern (as the
    drivers number them), in blocks."""
    out = {}
    for k, s in enumerate(op.OPERANDS):
        v = pat.values(seed, k)(pat.rows, pat.cols)
        m = R.block_matrix(pat.rows, pat.cols, v, pat.n, bs)
        out[s] = R.BlockMatrix(m.keys, m.blocks.astype(dtype), bs)
    return out


def test_float32_passes_and_tf32_control_fails_the_limit(tiny_root):
    """The control: the reference in TF32 in the program's place must fail
    the limit that a float32 product meets, on every configuration (each
    through its operator's reference)."""
    from pbench import bench
    from pbench.cell import reference_of
    b = bench.load_benchmark(tiny_root)
    for entry in b["configs"]:
        cfg = bench.load_config(tiny_root, b, entry["name"])
        pat = bench.load_pattern(BENCH, cfg).make(cfg)
        op = bench.load_operator(BENCH, cfg)
        bs = cfg["bs"]
        for seed in (1, 2, 3):
            want = reference_of(cfg, op, pat.upper, "cpu",
                                _operands(pat, op, bs, seed))[0]
            got32 = reference_of(cfg, op, pat.upper, "cpu",
                                 _operands(pat, op, bs, seed, np.float32),
                                 precision="float32")[0]
            ctl = reference_of(cfg, op, pat.upper, "cpu",
                               _operands(pat, op, bs, seed),
                               precision="tf32")[0]
            lim = cfg["limits"]["max_rel_err"]
            r32 = R.compare(R.as_blocks(got32), want)
            rtf = R.compare(R.as_blocks(ctl), want)
            assert r32["c_blocks_wrong"] == rtf["c_blocks_wrong"] == 0
            assert r32["max_rel_err"] <= lim < rtf["max_rel_err"], (
                entry["name"], seed, r32, rtf)


def test_operators_without_a_hook_multiply_every_structural_pair(
        tiny_root):
    """An operator with no ``reference_pairs`` gets the exact product over
    every structural pair, and the work counted from the pairs the
    reference multiplied is that of every structural pair: what the
    harness read before operators could define their products."""
    from pbench import bench
    from pbench.cell import reference_of
    from pbench.work import product_work
    b = bench.load_benchmark(tiny_root)
    for entry in b["configs"]:
        cfg = bench.load_config(tiny_root, b, entry["name"])
        pat = bench.load_pattern(BENCH, cfg).make(cfg)
        op = bench.load_operator(BENCH, cfg)
        assert not hasattr(op, "reference_pairs")
        bs = cfg["bs"]
        blocks = _operands(pat, op, bs, 7)
        got, a, bb = reference_of(cfg, op, pat.upper, "cpu", blocks)
        want = R.reference_product(*op.reference_operands(blocks), pat.upper)
        ia, ib, _, keys = R.block_pairs(a.keys, bb.keys, pat.upper)
        np.testing.assert_array_equal(got.keys, keys)
        np.testing.assert_array_equal(got.ia, ia)
        np.testing.assert_array_equal(got.ib, ib)
        assert bool((got.c == want.c).all())
        assert bool((got.scale == want.scale).all())
        assert product_work(a.keys, bb.keys, got.ia, got.ib, len(got.keys),
                            bs, pat.upper) == product_work(
            a.keys, bb.keys, ia, ib, len(keys), bs, pat.upper)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 3 * 2.0 ** -11)])
    assert R.tf32_round(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                        1.0, -(1.0 + 2 * 2.0 ** -10)]
