"""An operator file that defines its own product: a truncated square
(``A.multiply(A, tau)``, the SpAMM-style norm truncation) added as new
files in a copy of the benchmark, its reference keeping the block pairs
whose norm product reaches tau (``reference_pairs``).  The program reads
correct; tau planted at 0 or ten times its value, and the control, read
not correct; the work counted is the pairs the program multiplied."""
import json
import time

import numpy as np
import pytest

from pbench import bench, cell as cellmod, main, reference as R

CELL = "decay_test.trunc_eager"
TAU = 3e-4

PATTERN = '''\
import numpy as np
from pbench.inputs import Pattern, hash01


def make(cfg):
    """A band whose values decay as exp(-|i - j| / decay_length)."""
    n, d = int(cfg["n"]), int(cfg["half_bandwidth"])
    rows = np.repeat(np.arange(n), 2 * d + 1)
    cols = rows + np.tile(np.arange(-d, d + 1), n)
    ok = (cols >= 0) & (cols < n)
    rows, cols = rows[ok], cols[ok]
    length = float(cfg["decay_length"])

    def values(seed, k):
        def value_fn(r, c):
            r, c = np.asarray(r), np.asarray(c)
            return np.exp(-np.abs(r - c) / length) * (
                1.0 + 0.1 * hash01(r, c, seed, k))
        return value_fn
    return Pattern(n=n, rows=rows, cols=cols, upper=False, values=values)
'''

OPERATOR = f'''\
"""C = A A truncated: block pairs whose norm product is below TAU are
left out (``Matrix.multiply(tau=...)``)."""
import numpy as np

TAU = {TAU!r}
#: relative width around TAU within which the program's rounding of a
#: norm product could put a pair on either side
BRACKET = 1e-5
OPERANDS = ("A",)


def call(m):
    return m["A"].multiply(m["A"], tau=TAU)


def reference_operands(blocks):
    return blocks["A"], blocks["A"]


def reference_pairs(blocks, cfg, ia, ib):
    a, b = reference_operands(blocks)
    na = np.sqrt((a.blocks ** 2).sum(axis=(1, 2)))
    nb = np.sqrt((b.blocks ** 2).sum(axis=(1, 2)))
    bound = na[ia] * nb[ib]
    keep = bound >= TAU
    if (keep != (bound >= TAU * (1 + BRACKET))).any() or \\
            (keep != (bound >= TAU * (1 - BRACKET))).any():
        raise ValueError("a block pair's norm product lies within the "
                         "bracket around tau")
    return keep
'''

CONFIG = {"pattern": "decay_test", "n": 512, "half_bandwidth": 48,
          "decay_length": 4.0, "leaf_n": 128, "bs": 16, "dtype": "float32",
          "product": "trunc_square_test", "engine": "torch",
          "kernel": "pairs", "ranks": 1,
          "limits": {"c_blocks_wrong": 0, "max_rel_err": 1e-4}}


@pytest.fixture
def trunc_root(tiny_root, monkeypatch):
    """``tiny_root`` with the truncated square's pattern, operator,
    configuration and cell added as new files and entries; the harness
    finds its parts in that copy."""
    base = tiny_root / "portbench"
    (base / "patterns" / "decay_test.py").write_text(PATTERN)
    (base / "operators" / "trunc_square_test.py").write_text(OPERATOR)
    (base / "configs" / "decay_test.json").write_text(json.dumps(CONFIG))
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "decay_test", "source": "a test",
                         "file": "portbench/configs/decay_test.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": CELL, "config": "decay_test",
                           "traffic": "eager", "chips": 1, "why": "a test"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(bench, "HERE", base)
    return tiny_root


@pytest.fixture
def program_restored():
    from repro_torch.api.matrix import Matrix
    from repro_torch.kernels import ops
    saved = Matrix.multiply
    kernels = {k: getattr(ops, k) for k in ("bsmm_pairs", "batched_gemm")}
    yield
    Matrix.multiply = saved
    for k, v in kernels.items():
        setattr(ops, k, v)


def _parts(root):
    b = bench.load_benchmark(root)
    cfg = bench.load_config(root, b, "decay_test")
    pattern = bench.load_pattern(bench.HERE, cfg).make(cfg)
    return cfg, pattern, bench.load_operator(bench.HERE, cfg)


def _blocks(cfg, pattern, seed):
    vals = pattern.values(seed, 0)(pattern.rows, pattern.cols)
    return {"A": R.block_matrix(pattern.rows, pattern.cols, vals, pattern.n,
                                int(cfg["bs"]))}


def test_truncated_square_reads_correct_and_prunes(trunc_root):
    out = main.run(trunc_root, CELL, 2 ** 31 + 21, 0.3, False, time.time(),
                   device="cpu")
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["checks"]["max_rel_err"]["value"] > 0
    # the cut is real: fewer pairs and C blocks than the exact product
    cfg, pattern, op = _parts(trunc_root)
    a = _blocks(cfg, pattern, 2 ** 31 + 21)["A"]
    exact = R.reference_product(a, a, False)
    work = out["_diag"]["work"]
    assert work["pairs"] < exact.pairs
    assert work["c_blocks"] < len(exact.keys)


@pytest.mark.parametrize("fault,number", [("tau_zero", "c_blocks_wrong"),
                                          ("tau_times_ten", "c_blocks_wrong"),
                                          ("tf32_operands", "max_rel_err")])
def test_planted_fault_reads_incorrect(trunc_root, program_restored, fault,
                                       number):
    out = main.run(trunc_root, CELL, 2 ** 31 + 22, 0.2, False, time.time(),
                   device="cpu", plant=f"portbench_faults:{fault}")
    c = out["checks"][number]
    assert out["correct"] is False and out["failed"] >= 1
    assert c["value"] > c["limit"], out["checks"]


def test_work_counts_the_pairs_the_program_multiplied(trunc_root):
    b = bench.load_benchmark(trunc_root)
    cfg = bench.load_config(trunc_root, b, "decay_test")
    mix = bench.load_mix(bench.HERE, "eager")
    res = cellmod.rank_main(0, 1, {
        "cfg": cfg, "mix": mix, "seed": 2 ** 31 + 23, "seconds": 0.2,
        "trace": True, "device": "cpu", "backend": "gloo", "plant": None})
    assert res["failed"] == 0
    pairs = res["program"]["counters"]["engine.pairs"]
    assert pairs == res["work"].pairs * res["products"]


def test_hook_at_tau_zero_is_the_default_path(trunc_root, monkeypatch):
    cfg, pattern, op = _parts(trunc_root)
    blocks = _blocks(cfg, pattern, 5)
    monkeypatch.setattr(op, "TAU", 0.0)
    got, a, b = cellmod.reference_of(cfg, op, False, "cpu", blocks)
    want = R.reference_product(a, b, False)
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.ia, want.ia)
    np.testing.assert_array_equal(got.ib, want.ib)
    assert got.pairs == want.pairs
    assert bool((got.c == want.c).all()) and bool((got.scale ==
                                                   want.scale).all())
