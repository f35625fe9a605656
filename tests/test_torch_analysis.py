"""The port's §5 analysis (``repro_torch.core.analysis``) against the
reference's (``repro.core.analysis``).

Every public function runs on the same inputs through both modules: the
closed forms and counters on the inputs of ``tests/test_patterns_analysis.py``
and ``tests/test_task_counts.py``, the simulator summaries on reports and
the graph quantity on graphs that each package built from the same numpy
arrays.  The modules are numpy only, so results must be equal, not close.
"""
import inspect

import numpy as np
import pytest

pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import analysis as ref_an  # noqa: E402
from repro.core.patterns import (banded_mask, banded_pairs,  # noqa: E402
                                 divide_space_order, overlap_pairs,
                                 particle_cloud, random_mask, rmat_pairs,
                                 values_for_mask)
from repro_torch.core import analysis as port_an  # noqa: E402


def _random_coords(n, delta, seed):
    return np.nonzero(random_mask(n, delta, seed=seed))


def _overlap_coords():
    coords = particle_cloud(8, 3, seed=1)
    rows, cols = overlap_pairs(coords, 4.0, order=divide_space_order(coords))
    return rows, cols, 1 << int(np.ceil(np.log2(len(coords))))


L, DELTA, K = 8, 0.02, 3
BANDED = banded_pairs(1 << L, 1 << K)
RANDOM = _random_coords(1 << L, DELTA, 1)
RANDOM32 = _random_coords(32, 0.1, 3)
RMAT = rmat_pairs(9, 5.0, 0.9, seed=0)
OVERLAP = _overlap_coords()

#: (function, [argument tuples]) over the reference tests' inputs
CASES = {
    "random_tasks_at_level": [(L, DELTA, lv) for lv in range(L + 1)],
    "random_bound_low": [(lv,) for lv in range(L + 1)],
    "random_bound_high": [(L, DELTA, lv) for lv in range(L + 1)],
    "random_total_bound": [(1 << L, DELTA), (1 << 12, 1e-3)],
    "banded_d_at_level": [(L, K, lv) for lv in range(L + 1)]
    + [(10, 2, lv) for lv in range(11)],
    "banded_tasks_bound": [(L, K, lv) for lv in range(L + 1)],
    "banded_total_bound": [(1 << L, 1 << K), (64, 5)],
    "banded_multiply_flops": [(64, 3), (1 << L, 1 << K)],
    "overlap_tasks_model": [(L, dim, r, lv) for dim in (1, 2, 3)
                            for r in (0.5, 2.0, 6.0) for lv in range(L + 1)],
    "exec_time_random": [(1 << 12, 1e-3, p) for p in (4, 16)]
    + [(1 << 10, 0.01, 8, 2.0, 0.5)],
    "exec_time_banded": [(1 << 12, 8, p) for p in (4, 16)]
    + [(1 << 10, 3, 8, 2.0, 0.5)],
    "spsumma_elements_fetched_per_process": [(5, 1000, 4), (2.5, 4096, 16)],
    "spsumma_weak_scaling_elements": [(5, 10, 16), (49, 256, 4)],
    "comm_summary": [([162208, 143616, 150000, 100000],),
                     (np.array([0, 0, 0]),), ([7],)],
    "growth_ratios": [([1.0, 2.0, 3.0],), ([0.0, 1.0, 4.0],), ([5.0],)],
    "weak_scaling_growth": [({4: 1.0, 16: 1.5},), ({2: 3.0, 8: 2.0,
                                                    4: 4.0},)],
    "brent_bound": [(10.0, 2.0, 4), (10.0, 4.0, 4), (0.0, 0.0, 1)],
    "parallel_efficiency": [(8.0, 1.0, 8), (3.0, 2.0, 4), (1.0, 0.0, 4)],
    "avg_parallelism": [(8.0, 1.0), (1.0, 0.0)],
    "is_monotone_nonincreasing": [([3, 2, 2, 1],), ([1, 2],),
                                  ([1.0, 1.005], 0.01), ([1.0, 1.05], 0.01)],
    "critical_path_summary": [(8.0, 1.0, 4, 2.5), (0.01, 0.002, 16, 0.004)],
    "count_mult_tasks_pairs": [(*BANDED, *BANDED, 1 << L),
                               (*RANDOM, *RANDOM32, 1 << L)],
    "count_tasks_per_level_pairs": [(*BANDED, 1 << L),
                                    (*RANDOM, 1 << L),
                                    (*RANDOM32, 32),
                                    (*banded_pairs(1 << 10, 4), 1 << 10),
                                    (*RMAT, 1 << 9),
                                    (*OVERLAP,),
                                    (*RANDOM, 1 << L, *BANDED)],
    "nnz_per_row": [(BANDED[0], 1 << L), (RANDOM32[0], 32)],
}
#: the functions of the simulator and the task graph (tests below)
GRAPH_CASES = ("truncation_summary", "task_comm_demand")


def _public(module):
    return {name for name, fn in inspect.getmembers(module,
                                                    inspect.isfunction)
            if fn.__module__ == module.__name__ and not name.startswith("_")}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and (a == b or (a != a and b != b))


def test_every_public_function_is_covered():
    assert _public(ref_an) == _public(port_an)
    assert _public(ref_an) == set(CASES) | set(GRAPH_CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_closed_forms_and_counters_match_reference(name):
    for args in CASES[name]:
        want = getattr(ref_an, name)(*args)
        got = getattr(port_an, name)(*args)
        assert _equal(got, want), (name, args, got, want)


def _multiply_sessions(tau):
    """Build then multiply the same banded inputs in both packages (numpy
    engines), truncated at ``tau``; returns, per package, the session, the
    node count before the multiply and the multiply phase's report."""
    idx = np.arange(64)
    decay = 0.5 ** np.abs(np.subtract.outer(idx, idx))
    a = values_for_mask(banded_mask(64, 6), seed=2) * decay
    out = []
    for pkg in (repro, repro_torch):
        sess = pkg.Session(engine="numpy", leaf_n=16, bs=4, p=4, seed=1)
        A, B = sess.from_dense(a), sess.from_dense(a.T)
        sess.simulate()
        start = len(sess.graph.nodes)
        A.multiply(B, tau=tau)
        out.append((sess, start, sess.simulate(fresh_stats=True)))
    return out


@pytest.mark.parametrize("tau", [0.0, 5e-2])
def test_task_comm_demand_matches_reference(tau):
    (rs, r0, _), (ps, p0, _) = _multiply_sessions(tau)
    for start in (0, r0):
        assert port_an.task_comm_demand(ps.graph, start) == \
            ref_an.task_comm_demand(rs.graph, start)
    assert port_an.task_comm_demand(ps.graph, p0) > 0


def test_truncation_summary_matches_reference():
    (_, _, r_exact), (_, _, p_exact) = _multiply_sessions(0.0)
    (_, _, r_trunc), (_, _, p_trunc) = _multiply_sessions(5e-2)
    want = ref_an.truncation_summary(r_exact, r_trunc)
    got = port_an.truncation_summary(p_exact, p_trunc)
    assert _equal(got, want)
    assert got["flops_ratio"] < 1.0
