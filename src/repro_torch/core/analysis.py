"""Computational-cost analysis of the quadtree representation (paper §5).

Closed-form task-count and communication models, eqs (1)-(17), plus exact
combinatorial counters that evaluate the same quantities from nonzero
coordinate lists (used to verify the bounds in Figs 3-4 and to drive the
communication-scaling benchmarks of Figs 12-14).

Level convention matches the paper: level l = 0 is the root, l = L the leaf
level, blocksize 1 at the leaves, matrix dimension N = 2^L.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Random (uniform iid) sparsity — eqs (1)-(7)
# ---------------------------------------------------------------------------

def random_tasks_at_level(L: int, delta: float, l: int) -> float:
    """Eq (1): expected multiplication tasks at level l, E = 8^l * delta_l^2."""
    n_l = 2.0 ** (2 * (L - l))
    # 1 - (1-delta)^{n_l} computed stably via expm1/log1p
    delta_l = -np.expm1(n_l * np.log1p(-min(delta, 1.0 - 1e-300)))
    return (8.0 ** l) * delta_l ** 2


def random_bound_low(l: int) -> float:
    """Eq (2): C_l <= 8^l (tight at low levels)."""
    return 8.0 ** l


def random_bound_high(L: int, delta: float, l: int) -> float:
    """Eq (3): C_l <= 16^L delta^2 / 2^l (tight at high levels)."""
    return (16.0 ** L) * delta * delta / (2.0 ** l)


def random_total_bound(N: int, delta: float) -> float:
    """Eq (7): total tasks < (3 + 1/7) (delta N^2)^{3/2}."""
    return (22.0 / 7.0) * (delta * N * N) ** 1.5


# ---------------------------------------------------------------------------
# Banded sparsity — eqs (8)-(11)
# ---------------------------------------------------------------------------

def banded_d_at_level(L: int, k: int, l: int) -> int:
    """Eq (9): half-bandwidth of the level-l block occupancy, d = 2^k."""
    return 1 if l < L - k else 2 ** (l - (L - k))


def banded_tasks_bound(L: int, k: int, l: int) -> float:
    """Eq (8): C_l < 2^l (2 d_l + 1)^2."""
    d_l = banded_d_at_level(L, k, l)
    return (2.0 ** l) * (2 * d_l + 1) ** 2


def banded_total_bound(N: int, d: int) -> float:
    """Eq (11): total < (4+4/7) d^2 N + (5+1/3) d N + 2 N + 9 N / d."""
    return (32.0 / 7.0 * d * d + 16.0 / 3.0 * d + 2.0 + 9.0 / d) * N


def banded_multiply_flops(N: int, d: int) -> float:
    """Eq (16): scalar mul+add count for banded x banded, bandwidth 2d+1."""
    return 2.0 * (N * (2 * d + 1) ** 2 - (5.0 / 3.0) * d * (d + 1) * (2 * d + 1))


# ---------------------------------------------------------------------------
# Overlap (D-dimensional particle) sparsity — eq (12) scaling model
# ---------------------------------------------------------------------------

def overlap_tasks_model(L: int, dim: int, R_over_h_leaf: float, l: int
                        ) -> float:
    """Eq (12) + surrounding discussion: C_l ~ 2^l M_l^2.

    M_l = 3^D at high levels (boxes wider than R); at low levels M_l is
    proportional to the volume of a D-sphere of radius R/h_l with
    h_l ∝ 2^{(L-l)/D}.
    """
    h_ratio = 2.0 ** ((L - l) / dim)     # box width at level l / leaf width
    m_low = (R_over_h_leaf / h_ratio) ** dim
    m_l = min(3.0 ** dim, max(1.0, m_low))
    return (2.0 ** l) * m_l * m_l


# ---------------------------------------------------------------------------
# Execution-time models — eqs (13)-(14)
# ---------------------------------------------------------------------------

def exec_time_random(N: int, delta: float, p: int, c_work: float = 1.0,
                     c_crit: float = 1.0) -> float:
    """Eq (13): O((delta N^2)^{3/2} / p + log(N)^2)."""
    return c_work * (delta * N * N) ** 1.5 / p + c_crit * np.log2(N) ** 2


def exec_time_banded(N: int, d: int, p: int, c_work: float = 1.0,
                     c_crit: float = 1.0) -> float:
    """Eq (14): O(d^2 N / p + log(N)^2)."""
    return c_work * d * d * N / p + c_crit * np.log2(N) ** 2


# ---------------------------------------------------------------------------
# SpSUMMA communication — eqs (15), (17) and Table 1
# ---------------------------------------------------------------------------

def spsumma_elements_fetched_per_process(m: float, N: int, p: int) -> float:
    """Eq (15): 2 m N / sqrt(p) matrix elements fetched per process."""
    return 2.0 * m * N / np.sqrt(p)


def spsumma_weak_scaling_elements(m: float, k: float, p: int) -> float:
    """Eq (17): with N = k p (weak scaling), 2 m k sqrt(p) elements."""
    return 2.0 * m * k * np.sqrt(p)


# ---------------------------------------------------------------------------
# Exact counters from coordinate lists (drive Figs 3-4 at paper scale)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Per-worker communication / critical-path summaries of simulator runs
# (consumed by benchmarks/bench_comm_scaling.py, bench_weak_scaling.py and
# tests/test_scheduler.py; see repro_torch.runtime.scheduler)
# ---------------------------------------------------------------------------

def comm_summary(bytes_received: list[int] | np.ndarray) -> dict:
    """Per-worker communication summary (the quantities of Figs 11-13).

    ``imbalance`` is max/avg — 1.0 means perfectly even reception; the
    paper's locality argument is about the *max* (the straggler's bytes).
    """
    b = np.asarray(bytes_received, dtype=np.float64)
    avg = float(b.mean())
    return {
        "n_workers": int(b.size),
        "total_bytes": float(b.sum()),
        "avg_bytes": avg,
        "max_bytes": float(b.max()),
        "min_bytes": float(b.min()),
        "imbalance": float(b.max() / avg) if avg > 0 else 1.0,
    }


def growth_ratios(values: list[float]) -> list[float]:
    """Successive ratios v[i+1]/v[i] of a scaling series (0-safe)."""
    out = []
    for lo, hi in zip(values, values[1:]):
        out.append(float(hi) / float(lo) if lo > 0 else float("inf"))
    return out


def weak_scaling_growth(series: dict[int, float]) -> float:
    """Last/first of a {p: metric} weak-scaling series.

    ~1 means the per-worker metric is flat (the paper's O(1) claim for
    local patterns under locality-aware placement, Table 1); compare with
    ``sqrt(p_last / p_first)`` for the SpSUMMA rate of eq (17).
    """
    ps = sorted(series)
    first = series[ps[0]]
    return series[ps[-1]] / first if first > 0 else float("inf")


def brent_bound(work_s: float, critical_path_s: float, p: int) -> float:
    """Greedy-scheduling makespan lower bound max(T1/p, Tinf) (§5.3)."""
    return max(work_s / p, critical_path_s)


def parallel_efficiency(work_s: float, makespan_s: float, p: int) -> float:
    """T1 / (p * makespan): fraction of worker-time spent on useful work."""
    return work_s / (p * makespan_s) if makespan_s > 0 else 0.0


def avg_parallelism(work_s: float, critical_path_s: float) -> float:
    """T1 / Tinf: how many workers the DAG can keep busy on average."""
    return work_s / critical_path_s if critical_path_s > 0 else 0.0


def truncation_summary(exact, truncated) -> dict:
    """Reduction won by a truncated multiply, from two simulator phases.

    ``exact``/``truncated`` are :class:`~repro_torch.runtime.scheduler.SimReport`
    objects (or anything duck-typed alike) of the exact and the tau-pruned
    multiply phase over the same inputs.  Ratios are truncated/exact:
    below 1.0 means the pruning visibly shrank the quantity (tasks,
    fetched bytes, executed flops, critical path, makespan).
    """
    def ratio(t, e):
        return float(t) / float(e) if e else 1.0

    ex_bytes = sum(exact.bytes_received)
    tr_bytes = sum(truncated.bytes_received)
    out = {
        "task_ratio": ratio(truncated.n_tasks, exact.n_tasks),
        "bytes_ratio": ratio(tr_bytes, ex_bytes),
        "flops_ratio": ratio(truncated.total_flops, exact.total_flops),
        "makespan_ratio": ratio(truncated.makespan, exact.makespan),
        "n_tasks": (exact.n_tasks, truncated.n_tasks),
        "bytes_received": (ex_bytes, tr_bytes),
        "total_flops": (exact.total_flops, truncated.total_flops),
    }
    if exact.crit is not None and truncated.crit is not None:
        out["critical_path_ratio"] = ratio(truncated.crit.length_s,
                                           exact.crit.length_s)
    return out


def task_comm_demand(g, start: int = 0) -> int:
    """Fetched-dependency data volume of ``g.nodes[start:]`` in bytes.

    For every task registered at or after ``start``, sums the chunk sizes
    of its content-fetched dependencies (identifier-only deps move no
    data).  This is the communication *demand* the scheduler replays —
    what a cache-less cluster would receive — and unlike one stochastic
    work-stealing replay it is a pure graph quantity: truncation prunes
    tasks and shrinks result chunks, so demand decreases monotonically
    in tau.  Pass ``start`` = the node count before a phase to isolate
    that phase (e.g. the multiply registered after the build).
    """
    total = 0
    for n in g.nodes[start:]:
        for d in n.deps:
            if not d.fetch:
                continue
            dn = g.resolve(d.nid)
            if dn is not None:
                total += g.nodes[dn].out_nbytes
    return total


def is_monotone_nonincreasing(values, rtol: float = 0.0) -> bool:
    """True iff the series never grows by more than ``rtol`` relative.

    Used by the truncation benchmark: flops/tasks must be exactly
    non-increasing in tau (rtol=0); simulated communication is allowed a
    small scheduler-noise tolerance.
    """
    vals = [float(v) for v in values]
    for lo, hi in zip(vals, vals[1:]):
        if hi > lo * (1.0 + rtol) + 1e-12:
            return False
    return True


def critical_path_summary(work_s: float, critical_path_s: float,
                          p: int, makespan_s: float) -> dict:
    """Eq (13)/(14)-style decomposition of one simulated phase."""
    return {
        "work_s": work_s,
        "critical_path_s": critical_path_s,
        "avg_parallelism": avg_parallelism(work_s, critical_path_s),
        "brent_bound_s": brent_bound(work_s, critical_path_s, p),
        "makespan_s": makespan_s,
        "parallel_efficiency": parallel_efficiency(work_s, makespan_s, p),
    }


# ---------------------------------------------------------------------------
# Exact counters from coordinate lists (Figs 3-4 at paper scale), continued
# ---------------------------------------------------------------------------

def count_mult_tasks_pairs(rows_a: np.ndarray, cols_a: np.ndarray,
                           rows_b: np.ndarray, cols_b: np.ndarray,
                           n: int) -> int:
    """Number of (i,k,j) with A[i,k] != 0 and B[k,j] != 0.

    This is exactly the number of multiplication tasks at the level whose
    occupancy is given by the coordinate lists (paper counts both-nonzero
    products only).
    """
    col_count_a = np.bincount(cols_a, minlength=n).astype(np.int64)
    row_count_b = np.bincount(rows_b, minlength=n).astype(np.int64)
    return int(col_count_a @ row_count_b)


def count_tasks_per_level_pairs(rows: np.ndarray, cols: np.ndarray,
                                n: int,
                                rows_b: np.ndarray | None = None,
                                cols_b: np.ndarray | None = None
                                ) -> dict[int, int]:
    """Multiplication tasks at every quadtree level for C = A B.

    ``n`` must be a power of two; level L = log2(n) has blocksize 1.
    Occupancy at level l is the union of leaf occupancy coarsened by
    2^{L-l}; counts use :func:`count_mult_tasks_pairs` per level.
    """
    if rows_b is None:
        rows_b, cols_b = rows, cols
    L = int(np.log2(n))
    out: dict[int, int] = {}
    ra, ca = np.asarray(rows), np.asarray(cols)
    rb, cb = np.asarray(rows_b), np.asarray(cols_b)
    size = n
    for l in range(L, -1, -1):
        out[l] = count_mult_tasks_pairs(ra, ca, rb, cb, size)
        if l > 0:
            ra, ca = _coarsen(ra, ca, size)
            rb, cb = _coarsen(rb, cb, size)
            size //= 2
    return out


def _coarsen(rows: np.ndarray, cols: np.ndarray, n: int
             ) -> tuple[np.ndarray, np.ndarray]:
    g = n // 2
    uniq = np.unique((rows // 2) * g + (cols // 2))
    return uniq // g, uniq % g


def nnz_per_row(rows: np.ndarray, n: int) -> float:
    return len(rows) / n
