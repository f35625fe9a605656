"""Walkthrough: the Chunks-and-Tasks runtime simulator on the port.

The PyTorch/CUDA counterpart of ``examples/simulate_runtime.py``: builds a
banded matrix as a task program through :class:`repro_torch.Session`,
multiplies it with ``A @ B`` (one ``bsmm_pairs`` kernel wave on the card),
and replays the recorded DAG on a simulated 8-worker cluster under the
paper's locality-aware chunk placement and the locality-oblivious
baselines.  Prints per-worker communication (the Figs 11-13 quantities),
the critical-path decomposition behind the weak-scaling claim (eq (13)/
(14)), and an ASCII Gantt chart of worker occupancy.

Run: PYTHONPATH=src python examples/torch_simulate_runtime.py [--device cpu]

On the card the leaves of C are float32 (half the bytes of the numpy
engine's float64 leaves), so the simulated traffic differs from the
reference example's; ``--device cpu`` runs the numpy engine, which
reproduces the reference's numbers.
"""
import argparse

import numpy as np

from repro_torch import Session
from repro_torch.core import analysis as an
from repro_torch.core.patterns import banded_mask, values_for_mask
from repro_torch.runtime.scheduler import PLACEMENTS

P = 8
N, D, LEAF, BS = 1024, 24, 32, 8


def simulate(placement: str, engine: str):
    a = values_for_mask(banded_mask(N, D), seed=1, symmetric=True)
    sess = Session(engine=engine, leaf_n=LEAF, bs=BS, p=P,
                   placement=placement, seed=0)
    A = sess.from_dense(a)
    B = sess.from_dense(a)       # duplicated input, stored twice here —
    sess.simulate()              # opt-in Session(dedup=True) stores it once
    C = A @ B
    rep = sess.simulate(fresh_stats=True)            # measured multiply
    # float32 packing on the card; float64 on the numpy engine
    atol = 1e-3 if engine == "torch" else 1e-12
    np.testing.assert_allclose(C.to_dense(), a @ a, atol=atol)
    return rep


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the torch engine on the card; cpu: the "
                         "numpy engine")
    engine = "torch" if ap.parse_args().device == "cuda" else "numpy"
    print(f"banded N={N} (half-bandwidth {D}) multiply on {P} simulated "
          f"workers\n")
    reports = {}
    print(f"{'placement':14s} {'avg MB':>8s} {'max MB':>8s} "
          f"{'pushed':>8s} {'steals':>6s} {'makespan':>9s} {'eff':>5s}")
    for placement in PLACEMENTS:
        rep = simulate(placement, engine)
        reports[placement] = rep
        s = an.comm_summary(rep.bytes_received)
        print(f"{placement:14s} {s['avg_bytes'] / 1e6:8.3f} "
              f"{s['max_bytes'] / 1e6:8.3f} "
              f"{np.mean(rep.bytes_pushed) / 1e6:8.3f} "
              f"{rep.steals:6d} {rep.makespan * 1e3:7.2f}ms "
              f"{rep.parallel_efficiency:5.2f}")

    rep = reports["parent-worker"]
    gap = (max(reports["random"].bytes_received)
           / max(rep.bytes_received))
    print(f"\nlocality gap (random / parent-worker, max bytes): {gap:.2f}x")

    cp = rep.crit
    print(f"\ncritical path (parent-worker): T1={cp.work_s * 1e3:.2f}ms  "
          f"Tinf={cp.length_s * 1e3:.2f}ms  "
          f"avg parallelism={cp.avg_parallelism:.1f}  "
          f"Brent bound={cp.brent_bound(P) * 1e3:.2f}ms  "
          f"makespan={rep.makespan * 1e3:.2f}ms")
    kind_of = {ev.nid: ev.kind for ev in rep.trace.events}
    chain = [kind_of[nid] for nid in cp.path]
    compressed = [k for i, k in enumerate(chain)
                  if i == 0 or k != chain[i - 1]]
    print(f"critical chain ({len(cp.path)} tasks): "
          + " -> ".join(compressed))
    print("\nworker occupancy (parent-worker multiply phase; * = steal):")
    print(rep.trace.gantt(width=72))


if __name__ == "__main__":
    main()
