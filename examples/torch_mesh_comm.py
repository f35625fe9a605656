"""Walkthrough: the parent-worker multiply on ranks, with measured traffic.

The port's counterpart of the mesh run of ``benchmarks/bench_mesh_comm.py``:
``p`` ranks (processes on one ``torch.distributed`` gloo group, started by
``repro_torch.launch.mesh.launch_ranks``) each run the same host program —
banded ``A @ B`` at n = 128 p, leaf_n 32, bs 8 — through
``Session(engine=MeshEngine(...))``.  Every wave is split over the ranks;
the operand blocks a rank needs from another move by counted ring shifts,
and each rank's block products run as one kernel launch on its device.
Each rank prints its own view of the counters (the per-device lists are
gathered from every rank at each wave) and its kernel launches; rank 0
prints the record the benchmark writes.

Run: PYTHONPATH=src python examples/torch_mesh_comm.py [--ranks 2]
     [--device cpu | --backend nccl]

On one GPU the ranks share the card (``cuda:0``), and gloo stages the
shipped blocks through the host: the counters are those of p devices, the
times are not.  ``--device cpu`` runs the kernels' plain versions.  On a
host with one GPU a rank, ``--backend nccl`` puts rank r on ``cuda:r``
and ships the blocks between the cards.
"""
import argparse
import json

import numpy as np


def rank_main(rank: int, p: int, device: str, kernel: str) -> dict:
    if device == "nccl":
        device = f"cuda:{rank}"
    from repro_torch import Session
    from repro_torch.core.patterns import banded_mask, values_for_mask
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh_exec import MeshEngine

    n = 128 * p
    a = values_for_mask(banded_mask(n, 12), seed=1)
    b = values_for_mask(banded_mask(n, 7), seed=2)
    sess = Session(engine=MeshEngine(kernel=kernel, device=device),
                   leaf_n=32, bs=8)
    A, B = sess.from_dense(a), sess.from_dense(b)
    _build.reset_launches()
    C = A @ B
    np.testing.assert_allclose(C.to_dense(), a @ b, atol=1e-3)
    st = sess.engine_stats()
    print(f"rank {rank}/{p} on {device}: launches {dict(_build.LAUNCHES)}; "
          f"fetched_bytes {st['fetched_bytes']} pushed_bytes "
          f"{st['pushed_bytes']} collective_bytes {st['collective_bytes']}",
          flush=True)
    return {"scheme": "mesh", "p": p, "n": n,
            "max_fetched_bytes_per_dev": max(st["fetched_bytes"]),
            "sum_fetched_blocks": sum(st["fetched_blocks"]),
            "max_pushed_bytes_per_dev": max(st["pushed_bytes"]),
            "max_collective_bytes_per_dev": max(st["collective_bytes"]),
            "waves": st["waves"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda:0",
                    help="each rank's kernel device (cpu: plain versions)")
    ap.add_argument("--kernel", default="gemm", choices=("gemm", "pairs"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="nccl: rank r on cuda:r, one GPU a rank")
    args = ap.parse_args()
    from repro_torch.launch.mesh import launch_ranks
    device = "nccl" if args.backend == "nccl" else args.device
    recs = launch_ranks(rank_main, args.ranks, args=(device, args.kernel),
                        backend=args.backend)
    print("record: " + json.dumps(recs[0]))


if __name__ == "__main__":
    main()
