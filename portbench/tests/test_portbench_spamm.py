"""The truncated square of a decaying density stand-in
(``density_spamm.eager``: ``patterns/density.py``,
``operators/spamm_square.py``) at a host cut of its configuration: the
program reads correct and prunes about half the block pairs; tau planted
at 1.01 times or at 0 times its value, and the control, read not
correct; the reference refuses a pair it cannot decide; the pattern is
the overlap cloud's."""
import json
import time

import numpy as np
import pytest

from pbench import bench, cell as cellmod, main, reference as R

CELL = "density_spamm.eager"
#: tau at the host cut (8 particles a side, bs 16), where it keeps about
#: half of X X's block pairs, as 3.5e-4 does at the committed size
TINY_TAU = 6e-4
#: the per-layer metrics a host run of the cell reports: those that list
#: it or list no cell, but the device's
HOST_SILENT = {"idle_share", "bsmm_pairs_roofline"}
FAULTS = [("spamm_faults:tau_one_percent_high", "c_blocks_wrong"),
          ("portbench_faults:tau_zero", "c_blocks_wrong"),
          ("portbench_faults:tf32_operands", "max_rel_err")]
#: the controls' window on the card at the committed size: long enough
#: for the 4 or more products a run checks 3 of
CONTROL_SECONDS = 16.0


@pytest.fixture
def spamm_root(tiny_root, monkeypatch):
    """``tiny_root``, the harness finding its parts in that copy, whose
    operator runs at the host cut's tau."""
    base = tiny_root / "portbench"
    op = base / "operators" / "spamm_square.py"
    src = op.read_text()
    assert "\nTAU = 3.5e-4\n" in src
    op.write_text(src.replace("\nTAU = 3.5e-4\n", f"\nTAU = {TINY_TAU!r}\n"))
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
    cfg = bench.load_config(root, b, "density_spamm")
    pattern = bench.load_pattern(bench.HERE, cfg).make(cfg)
    return b, cfg, pattern, bench.load_operator(bench.HERE, cfg)


def _x(cfg, pattern, seed):
    vals = pattern.values(seed, 0)(pattern.rows, pattern.cols)
    return R.block_matrix(pattern.rows, pattern.cols, vals, pattern.n,
                          int(cfg["bs"]))


@pytest.mark.parametrize("trace", [False, True])
def test_truncated_square_reads_correct_at_a_host_cut(spamm_root, trace):
    seed = 2 ** 31 + 29
    out = main.run(spamm_root, CELL, seed, 0.5, trace, time.time(),
                   device="cpu")
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["checks"]["c_blocks_wrong"]["value"] == 0
    assert 0 < out["checks"]["max_rel_err"]["value"] <= 1e-5
    b, cfg, pattern, op = _parts(spamm_root)
    x = _x(cfg, pattern, seed)
    exact = R.reference_product(x, x, False)
    work = out["_diag"]["work"]
    assert 0.45 <= work["pairs"] / exact.pairs <= 0.55
    assert work["c_blocks"] < len(exact.keys)
    cell = bench.find_cell(b, CELL)
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench.metrics_of(b, cell, kind)}
    if trace:
        want -= HOST_SILENT
        assert "prune_ms" in want
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("fault,number", FAULTS)
def test_planted_fault_reads_incorrect(spamm_root, program_restored, fault,
                                       number):
    out = main.run(spamm_root, CELL, 2 ** 31 + 30, 0.3, False, time.time(),
                   device="cpu", plant=fault)
    c = out["checks"][number]
    assert out["correct"] is False and out["failed"] >= 1
    assert c["value"] > c["limit"], out["checks"]


def test_the_program_multiplies_the_pairs_the_reference_keeps(spamm_root):
    b, cfg, pattern, op = _parts(spamm_root)
    mix = bench.load_mix(bench.HERE, "eager")
    res = cellmod.rank_main(0, 1, {
        "cfg": cfg, "mix": mix, "seed": 2 ** 31 + 31, "seconds": 0.3,
        "trace": True, "device": "cpu", "backend": "gloo", "plant": None})
    assert res["failed"] == 0
    counters = res["program"]["counters"]
    assert counters["engine.pairs"] == res["work"].pairs * res["products"]
    assert counters["trunc.pairs_pruned"] > 0
    assert counters["trunc.test_s"] > 0


@pytest.mark.parametrize("rel,raises", [(5e-10, True), (-5e-10, True),
                                        (1e-6, False)])
def test_reference_refuses_a_pair_within_its_bracket(rel, raises):
    op = bench.load_operator(bench.HERE, {"product": "spamm_square"})
    bs = 4
    # two diagonal blocks: (0, 0) alone has norm product tau (1 + rel);
    # (1, 1)'s is far above tau
    blocks = np.zeros((2, bs, bs))
    blocks[0, 0, 0] = np.sqrt(op.TAU * (1 + rel))
    blocks[1] = np.eye(bs)
    x = R.BlockMatrix(np.array([[0, 0], [1, 1]]), blocks, bs)
    ia, ib = np.array([0, 1]), np.array([0, 1])
    if raises:
        with pytest.raises(ValueError, match="tau"):
            op.reference_pairs({"X": x}, {}, ia, ib)
    else:
        keep = op.reference_pairs({"X": x}, {}, ia, ib)
        assert keep.tolist() == [True, True]


def test_density_pattern_is_the_overlap_cloud():
    cfg = json.loads((bench.HERE / "configs" / "density_spamm.json")
                     .read_text())
    s2 = json.loads((bench.HERE / "configs" / "overlap_s2.json").read_text())
    for k in ("particles_per_axis", "dim", "spacing", "jitter",
              "pattern_seed", "cutoff", "leaf_n", "bs"):
        assert cfg[k] == s2[k], k
    cfg["particles_per_axis"] = s2["particles_per_axis"] = 8
    d = bench.load_pattern(bench.HERE, cfg).make(cfg)
    o = bench.load_pattern(bench.HERE, s2).make(s2)
    assert d.n == o.n and not d.upper and o.upper
    np.testing.assert_array_equal(d.rows, o.rows)
    np.testing.assert_array_equal(d.cols, o.cols)
    v = d.values(9, 0)
    np.testing.assert_array_equal(v(d.rows, d.cols), v(d.cols, d.rows))
    # exp(-r / 0.5) (1 + noise/10): the diagonal within 5% of 1
    diag = v(np.arange(d.n), np.arange(d.n))
    assert (np.abs(diag - 1) <= 0.05).all()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3000029101])
@pytest.mark.parametrize("fault,number", FAULTS)
def test_controls_read_incorrect_at_the_cells_size(cuda, program_restored,
                                                   fault, number, seed):
    """The controls through the harness's own check, at the committed
    size (run: ``python -m pytest -q -s -m cuda portbench/tests -k
    spamm`` on a machine with a card; prints each reading)."""
    from conftest import ROOT
    out = main.run(ROOT, CELL, seed, CONTROL_SECONDS, False, time.time(),
                   device="cuda", plant=fault)
    print(f"control {fault} seed {seed}: {json.dumps(out['checks'])} "
          f"products {out['attempted']}")
    c = out["checks"][number]
    assert out["correct"] is False and out["failed"] >= 1
    assert c["value"] > c["limit"], out["checks"]
