"""The port's distributed multiplies against the reference's.

The host planning (owners, ``DistPlan``, ``DemandPlan``, ``SummaPlan``,
``distribute_morton`` / ``gather_dense`` / ``distribute_panels``) must
equal the reference's exactly.  The multiplies run on gloo CPU ranks in a
subprocess (tests/torch_dist_scenarios.py, one process per rank): halo v1,
demand v2 and SpSUMMA against float64 within 1e-3, v2's counted bytes
below v1's, and SpSUMMA's counted bytes per rank those of the committed
``BENCH_mesh_comm.json`` (219,648 at p = 4, 878,592 at p = 16).
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import distributed as r_dist  # noqa: E402
from repro.core import spsumma as r_summa  # noqa: E402
from repro.core.patterns import (banded_mask,  # noqa: E402
                                 block_mask_from_element_mask, random_mask,
                                 values_for_mask)
from repro_torch.core import distributed as t_dist  # noqa: E402
from repro_torch.core import spsumma as t_summa  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "tests" / "torch_dist_scenarios.py"


@functools.lru_cache(maxsize=None)
def run_ranks(p: int, *names: str) -> dict:
    """Rank 0's results of the named scenarios on p gloo CPU ranks."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(SCRIPT), str(p), *names],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, f"{names} on {p} ranks failed:\n" \
        f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}"
    assert res.stdout.rstrip().endswith("OK")
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


#: the scenarios one run of 4 ranks goes through
P4 = ("halo_random_pattern", "halo_pair_kernel", "demand_pair_kernel",
      "summa_correctness", "summa_random_permutation", "summa_bytes")


def _same(port_plan, ref_plan) -> bool:
    """Equal field for field (the two dataclasses are different types)."""
    return dataclasses.asdict(port_plan) == dataclasses.asdict(ref_plan)


def _masks(n=256, bs=8, d=12, seed=1):
    a = values_for_mask(banded_mask(n, d), seed=seed).astype(np.float32)
    b = values_for_mask(banded_mask(n, d // 2 + 1),
                        seed=seed + 1).astype(np.float32)
    return (a, b, block_mask_from_element_mask(np.abs(a) > 0, bs),
            block_mask_from_element_mask(np.abs(b) > 0, bs))


class TestPlanningEqualsReference:
    @pytest.mark.parametrize("grid,n_dev", [(8, 4), (4, 3), (8, 5), (4, 7),
                                            (16, 6), (4, 20)])
    def test_owners(self, grid, n_dev):
        for fn in ("morton_owner", "rowmajor_owner"):
            np.testing.assert_array_equal(getattr(t_dist, fn)(grid, n_dev),
                                          getattr(r_dist, fn)(grid, n_dev))

    @pytest.mark.parametrize("n_dev", [1, 2, 4, 8, 6])
    def test_dist_and_demand_plans(self, n_dev):
        _, _, ma, mb = _masks()
        assert _same(t_dist.plan_distribution(ma, mb, 8, n_dev),
                     r_dist.plan_distribution(ma, mb, 8, n_dev))
        tp = t_dist.plan_demand(ma, mb, 8, n_dev)
        rp = r_dist.plan_demand(ma, mb, 8, n_dev)
        for f in ("grid", "bs", "n_dev", "cap_d", "cap_c_d", "pair_caps",
                  "shifts", "halo_cap"):
            assert getattr(tp, f) == getattr(rp, f), f
        np.testing.assert_array_equal(tp.selA, rp.selA)
        np.testing.assert_array_equal(tp.selB, rp.selB)

    def test_random_pattern_plans(self):
        a = values_for_mask(random_mask(128, 0.05, seed=3), seed=3)
        ma = block_mask_from_element_mask(np.abs(a) > 0, 8)
        assert _same(t_dist.plan_distribution(ma, ma, 8, 4),
                     r_dist.plan_distribution(ma, ma, 8, 4))

    def test_distribute_and_gather(self):
        a, _, ma, mb = _masks()
        plan = t_dist.plan_distribution(ma, mb, 8, 4)
        got = t_dist.distribute_morton(a, 8, plan)
        for x, y in zip(got, r_dist.distribute_morton(a, 8, plan)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(
            t_dist.gather_dense(*got, plan.grid, 8),
            r_dist.gather_dense(*got, plan.grid, 8))
        np.testing.assert_array_equal(t_dist.gather_dense(*got, plan.grid,
                                                          8), a)

    @pytest.mark.parametrize("pgrid,perm", [(1, None), (2, None), (4, None),
                                            (2, 5)])
    def test_summa_plans_and_panels(self, pgrid, perm):
        a, b, ma, mb = _masks()
        if perm is not None:
            perm = t_summa.random_block_permutation(32, seed=perm)
            np.testing.assert_array_equal(
                perm, r_summa.random_block_permutation(32, seed=5))
            ma, mb = ma[np.ix_(perm, perm)], mb[np.ix_(perm, perm)]
        sp = t_summa.plan_summa(ma, mb, 8, pgrid)
        assert _same(sp, r_summa.plan_summa(ma, mb, 8, pgrid))
        for x, y in zip(t_summa.distribute_panels(a, 8, sp, perm=perm),
                        r_summa.distribute_panels(a, 8, sp, perm=perm)):
            np.testing.assert_array_equal(x, y)

    def test_bench_summa_caps(self):
        """The bench's SpSUMMA program: cap_panel 208 at p = 4 and 416 at
        p = 16, so 2 pgrid cap_panel (4 bs^2 + 8) bytes a rank."""
        for p, cap, want in ((4, 208, 219648), (16, 416, 878592)):
            n = 128 * p
            a = values_for_mask(banded_mask(n, 12), seed=1)
            ma = block_mask_from_element_mask(np.abs(a) > 0, 8)
            pg = t_summa.summa_pgrid(p)
            sp = t_summa.plan_summa(ma, ma, 8, pg)
            assert _same(sp, r_summa.plan_summa(ma, ma, 8, pg))
            assert sp.cap_panel == cap
            assert 2 * pg * cap * (4 * 8 ** 2 + 8) == want

    def test_owned_mask_consistent_with_morton_owner(self):
        for grid, n_dev in [(8, 4), (4, 3), (8, 5), (4, 7)]:
            owner = t_dist.morton_owner(grid, n_dev)
            for dev in range(n_dev):
                np.testing.assert_array_equal(
                    t_dist._owned_mask(grid, n_dev, dev).numpy(),
                    owner == dev)

    def test_owned_mask_int32_range(self):
        with pytest.raises(ValueError, match="int32"):
            t_dist._owned_mask(2 ** 14, 8, 0)


class TestFailFast:
    def test_summa_pgrid(self):
        for p in (6, 0, 3):
            with pytest.raises(ValueError):
                t_summa.summa_pgrid(p)
        assert t_summa.summa_pgrid(16) == 4

    def test_summa_p6_on_ranks(self):
        run_ranks(6, "summa_pgrid_validation")

    def test_plan_needs_a_divisible_grid(self):
        ma = np.ones((6, 6), bool)
        with pytest.raises(ValueError, match="divisible"):
            t_summa.plan_summa(ma, ma, 8, 4)

    def test_world_of_one_refuses_a_bigger_plan(self):
        _, _, ma, mb = _masks()
        plan = t_dist.plan_distribution(ma, mb, 8, 4)
        shard = [torch.from_numpy(x[0]) for x in
                 t_dist.distribute_morton(np.zeros((256, 256), np.float32),
                                          8, plan) * 2]
        with pytest.raises(ValueError, match="4 devices"):
            t_dist.halo_spmm(None, "dev", plan, *shard)


class TestOnRanks:
    """gloo CPU ranks, one process each (ports of dist_scenarios.py)."""

    P4 = P4

    def test_halo_correctness_p8(self):
        out = run_ranks(8, "halo_correctness", "demand_halo_v2")
        assert out["halo_correctness"]["pairs"] > 0

    def test_demand_v2_ships_less_than_v1_p8(self):
        v = run_ranks(8, "halo_correctness", "demand_halo_v2")[
            "demand_halo_v2"]
        assert 0 < v["v2_bytes"] < v["v1_bytes"]

    @pytest.mark.parametrize("scenario", P4)
    def test_scenario_p4(self, scenario):
        assert scenario in run_ranks(4, *self.P4)

    def test_demand_pair_kernel_ships_less_p4(self):
        v = run_ranks(4, *self.P4)["demand_pair_kernel"]
        assert 0 < v["v2_bytes"] < v["v1_bytes"]

    @pytest.mark.parametrize("p,want", [(4, 219648), (16, 878592)])
    def test_summa_counted_bytes(self, p, want):
        """Result bytes of the six all-gathers, own shard included (the
        reference's HLO convention), on every rank."""
        out = run_ranks(4, *self.P4) if p == 4 else run_ranks(16,
                                                              "summa_bytes")
        rec = out["summa_bytes"]
        assert rec["collective_bytes_by_rank"] == [want] * p
        doc = json.loads((ROOT / "BENCH_mesh_comm.json").read_text())
        (bench,) = [r for r in doc["records"]
                    if r["scheme"] == "summa" and r["p"] == p]
        assert bench["coll_bytes_per_dev"] == want


def test_rank_main_meets_at_a_barrier_before_teardown(monkeypatch):
    """``_rank_main`` calls ``dist.barrier()`` after ``fn`` returns and
    before ``destroy_process_group()``, so no rank tears the group down
    while another is still joining it; a rank whose ``fn`` raises skips
    the barrier, still tears down, and raises.  ``torch.distributed`` is
    patched: no process is started."""
    from repro_torch.launch import mesh as lmesh
    calls = []
    for name in ("init_process_group", "barrier", "destroy_process_group"):
        monkeypatch.setattr(lmesh.dist, name,
                            lambda *a, _n=name, **k: calls.append(_n))

    class Results:
        def put(self, item):
            calls.append(("put", item))

    def fn(rank, world_size, x):
        calls.append("fn")
        return x + rank

    lmesh._rank_main(fn, 1, 2, "/nonexistent/store", "gloo", 1.0, (41,),
                     Results())
    assert calls == ["init_process_group", "fn", "barrier",
                     ("put", (1, 42)), "destroy_process_group"]

    def bad(rank, world_size):
        raise RuntimeError("boom")

    calls.clear()
    with pytest.raises(RuntimeError, match="boom"):
        lmesh._rank_main(bad, 0, 2, "/nonexistent/store", "gloo", 1.0, (),
                         Results())
    assert calls == ["init_process_group", "destroy_process_group"]
