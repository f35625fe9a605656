"""Serving concurrent multiply / purification requests over shared plans,
on the port.

    PYTHONPATH=src python examples/torch_serve_plans.py [--device cpu]

The PyTorch/CUDA counterpart of ``examples/serve_plans.py``.  A
:class:`repro_torch.serve.PlanServer` owns a pool of lazy sessions, each
with its own ``TorchEngine`` on the card, and accepts concurrent requests
against registered matrices.  Three mechanisms do the work:

* **Admission control** — ``submit`` queues up to ``max_queue`` requests
  and rejects further ones with a typed reason; ``max_inflight`` requests
  advance per serving batch.
* **Cross-session plan cache** — request shapes are matched to compiled
  plan replicas by structural fingerprint.  The first request of a shape
  compiles; every later same-shape request rebind-replays with **zero
  new task registrations**, whichever session serves it.
* **Cross-plan wave coalescing** — in-flight plans run deferred, then
  one coalescer pass merges their compatible leaf waves — across
  sessions on the same device — into single ``bsmm_pairs`` launches, and
  the results are bitwise identical to serving each request alone.

The script serves a mixed workload (matrix products + an SP2
purification request), then prints the per-request accounting and the
server's unified counters.  ``--device cpu`` runs the kernels' plain
PyTorch versions (``PlanServer(device="cpu")``); the default needs a CUDA
device and counts the kernel's launches.
"""
import argparse

import numpy as np

from repro_torch.kernels import ops
from repro_torch.serve import AdmissionError, PlanServer, Request


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the CUDA kernels on the card; cpu: their "
                         "plain PyTorch versions")
    device = None if ap.parse_args().device == "cuda" else "cpu"
    rng = np.random.default_rng(7)
    n = 64
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    h = rng.standard_normal((n, n))
    h = (h + h.T) / 2
    w, v = np.linalg.eigh(h)
    x0 = v @ np.diag((w.max() - w) / (w.max() - w.min())) @ v.T

    srv = PlanServer(device=device, n_sessions=2, max_inflight=4,
                     max_queue=8, leaf_n=16, bs=4, trace=True)
    launches0 = ops.LAUNCHES["bsmm_pairs"]
    srv.register("A", a)
    srv.register("B", b)
    srv.register("X", x0)

    # a mixed workload: products in both orders plus one purification
    tickets = [srv.submit(Request.multiply("A", "B")),
               srv.submit(Request.multiply("B", "A")),
               srv.submit(Request.sp2("X", ne=n / 2, iters=6)),
               srv.submit(Request.multiply("A", "A"))]
    srv.drain()
    tasks_warm = srv.task_count()

    # warm traffic: same shapes, different values -> pure rebind-replay
    warm = [srv.submit(Request.multiply("B", "B")),
            srv.submit(Request.multiply("A", "B"))]
    srv.drain()
    assert srv.task_count() == tasks_warm, "warm requests registered tasks"

    # admission control: overfill the queue
    try:
        for _ in range(20):
            srv.submit(Request.multiply("A", "B"))
    except AdmissionError as exc:
        print(f"rejected with reason={exc.reason!r}: {exc}")
    srv.drain()

    print(f"\n{srv!r}")
    print(f"{'ticket':>6} {'kind':>8} {'status':>6} {'hits':>4} "
          f"{'miss':>4} {'queue_ms':>8} {'compile_ms':>10} "
          f"{'replay_ms':>9} {'KiB':>8}")
    for t in tickets + warm:
        print(f"{t.id:>6} {t.request.kind:>8} {t.status:>6} "
              f"{t.cache_hits:>4} {t.cache_misses:>4} "
              f"{t.queue_s * 1e3:>8.2f} {t.compile_s * 1e3:>10.2f} "
              f"{sum(t.replay_s) * 1e3:>9.2f} {t.bytes / 1024:>8.1f}")

    # float32 packing: the reference's float32 tolerance
    np.testing.assert_allclose(tickets[0].result, a @ b, atol=1e-3)
    np.testing.assert_allclose(warm[0].result, b @ b, atol=1e-3)
    print("\nresults validated against dense numpy")

    print("\ncoalescer:", srv.coalescer.counters())
    print("shared cache:", srv.cache.counters())
    spans = [s.name for s in srv.tracer.spans]
    print("spans:", {nm: spans.count(nm) for nm in sorted(set(spans))
                     if nm.startswith("serve")})
    engines = {str(s.graph.engine.device) for s in srv.sessions}
    launched = ops.LAUNCHES["bsmm_pairs"] - launches0
    print(f"engines on {sorted(engines)}; bsmm_pairs kernel launches: "
          f"{launched} (the plain versions on the CPU count none)")


if __name__ == "__main__":
    main()
