"""SP2 density-matrix purification on compiled, re-executable Plans, on
the port.

    PYTHONPATH=src python examples/torch_sp2_purification.py [--device cpu]

The PyTorch/CUDA counterpart of ``examples/sp2_purification.py``.  The
SP2 algorithm (Niklasson's trace-correcting purification) computes the
density matrix P — the spectral projector onto the n_occ lowest
eigenstates of a Hamiltonian H — purely with matrix multiplications:

    X_0   = (lam_max I - H) / (lam_max - lam_min)
    X_k+1 = X_k**2            if trace(X_k) > n_occ     (shrinks trace)
          = 2 X_k - X_k**2    otherwise                 (grows trace)

Each structure compiles **once** into a :class:`repro_torch.Plan` and
every later iteration rebinds the input values and replays — on the card
every replay of ``X @ X`` is one ``bsmm_pairs`` wave:

* ``plan_sq  = sess.compile(X @ X)``       — Y = X²
* ``plan_pol = sess.compile(2*X - Y)``     — 2X − X² (scale+add programs)

The loop checks, per iteration, that **zero new tasks** are registered
and that the simulated per-iteration task count on the virtual cluster is
flat (``Plan.simulate`` replays the fixed program with fresh stats), then
validates the converged density matrix against a dense
eigendecomposition.  ``--device cpu`` runs the numpy engine (float64,
the reference's tolerances); on the card the leaves are float32 and the
checks use the reference's float32 tolerances (tests/test_solvers.py:
5e-3 on the density, here in the Frobenius norm; 1e-3 on the occupation)
and 1e-4 on idempotency.  The float32 loop also stops once it reaches
that idempotency: past convergence the trace-correcting branch keeps
choosing one map, and float32 rounding then grows each step (after 40
iterations ||X^2 - X|| is about 2e-3 and rising), where the float64
loop's rounding stays below 1e-10 for the 40 iterations it runs.
"""
import argparse

import numpy as np

from repro_torch import Session

#: (trace, idempotency, density) tolerances per engine
TOLS = {"numpy": (1e-6, 1e-6, 1e-6), "torch": (1e-3, 1e-4, 5e-3)}


def make_hamiltonian(n: int, seed: int = 0, rate: float = 4.0
                     ) -> np.ndarray:
    """Dense symmetric H with exponentially decaying off-diagonal weight
    (the shape of a localized-orbital Hamiltonian).  Full block support,
    so the SP2 iterates keep one sparsity structure — the precondition
    for rebinding one compiled plan across iterations."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n)
    decay = np.exp(-np.abs(idx[:, None] - idx[None, :]) / rate)
    h = rng.standard_normal((n, n)) * decay
    return (h + h.T) / 2.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the torch engine on the card; cpu: the "
                         "numpy engine")
    engine = "torch" if ap.parse_args().device == "cuda" else "numpy"
    tol_trace, tol_idem, tol_err = TOLS[engine]
    n, n_occ, iters = 128, 40, 40
    h = make_hamiltonian(n)
    lam = np.linalg.eigvalsh(h)
    x0 = (lam[-1] * np.eye(n) - h) / (lam[-1] - lam[0])

    sess = Session(engine=engine, lazy=True, leaf_n=32, bs=8, p=4, seed=0)
    X = sess.from_dense(x0, name="X")
    sess.simulate()                         # build phase places the input

    plan_sq = sess.compile(X @ X)           # Y = X^2
    Y = plan_sq.run()                       # first run lowers + executes
    plan_pol = sess.compile(2.0 * X - Y)    # Z = 2X - X^2 (binds X and Y)
    plan_pol.run()                          # lower the program up front

    print(f"SP2 purification: n={n}, n_occ={n_occ}")
    print(f"  plan_sq : {plan_sq.n_tasks} tasks, "
          f"inputs {plan_sq.input_names}")
    print(f"  plan_pol: {plan_pol.n_tasks} tasks (scale+add programs)")

    graph_sizes, sim_tasks, traces = [], [], []
    tr_x = float(np.trace(x0))              # trace of the current iterate
    Xc = None
    for it in range(iters):
        if it > 0:
            Y = plan_sq.run(X=Xc)           # rebind + replay: zero new tasks
        ntasks = plan_sq.simulate().n_tasks     # fixed-program replay
        if tr_x > n_occ:
            Xc = Y                          # X <- X^2       (trace shrinks)
        else:
            Xc = plan_pol.run()             # X <- 2X - X^2  (trace grows)
            ntasks += plan_pol.simulate().n_tasks
        tr_x = Xc.trace()
        traces.append(tr_x)
        graph_sizes.append(len(sess.graph.nodes))
        sim_tasks.append(ntasks)
        if engine == "torch":           # float32: stop at its floor
            x = Xc.to_dense()
            if np.linalg.norm(x @ x - x) < tol_idem:
                break

    print(f"  final trace: {traces[-1]:.6f} (target {n_occ})")

    # --- flat per-iteration cost ------------------------------------------
    assert len(set(graph_sizes)) == 1, \
        f"graph grew across iterations: {graph_sizes}"
    assert min(sim_tasks) == plan_sq.n_tasks > 0
    assert max(sim_tasks) <= plan_sq.n_tasks + plan_pol.n_tasks
    print(f"  graph size flat at {graph_sizes[-1]} nodes over "
          f"{len(graph_sizes)} iterations; per-iteration simulated tasks in "
          f"[{min(sim_tasks)}, {max(sim_tasks)}] (sq / sq+poly)")

    # --- correctness: X converged to the spectral projector --------------
    x = Xc.to_dense()
    assert abs(Xc.trace() - n_occ) < tol_trace
    idem = np.linalg.norm(x @ x - x)
    assert idem < tol_idem, f"not idempotent: ||X^2 - X|| = {idem:.2e}"
    w, v = np.linalg.eigh(h)
    p_ref = v[:, :n_occ] @ v[:, :n_occ].T
    err = np.linalg.norm(x - p_ref)
    assert err < tol_err, f"density matrix off by {err:.2e}"
    print(f"  ||X^2 - X||_F = {idem:.2e}, ||X - P_eig||_F = {err:.2e}: OK")

    # --- communication story (paper Figs 11-13, per iteration) -----------
    mb = np.asarray(plan_sq.simulate().bytes_received) / 1e6
    print(f"  per-iteration comm (X^2 replay, parent-worker, p=4): "
          f"avg {mb.mean():.3f} MB/worker, max {mb.max():.3f} MB")


if __name__ == "__main__":
    main()
