"""The command: run one cell once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
with ``--trace 1``), and last ``checks``, each number compared beside its
limit, which also close standard error.  With ``--trace 0`` the metrics
are the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.
A run that finds no CUDA device, fewer than the cell's chips, or a module
of JAX or of the JAX package loaded once the window has closed, exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

from pbench import bench, cell as cellmod, guard, spans as sp
from pbench.work import FP32_3XTF32_FLOPS, least_s

#: libraries' build and compile caches, at fixed paths in the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton"}


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(root: pathlib.Path, name: str, seed: int, seconds: float,
        trace: bool, t_start: float, device: str = "cuda",
        backend: str = "nccl", plant: str | None = None) -> dict:
    """Run cell ``name`` once; returns its result (the line's object).

    ``device="cpu"`` (with ``backend="gloo"`` for several ranks) runs the
    kernels' plain versions on the host, for the benchmark's own tests;
    ``plant`` ("module:function") is called in every rank before set-up,
    where a test plants a fault."""
    b = bench.load_benchmark(root)
    cell = bench.find_cell(b, name)
    cfg = bench.load_config(root, b, cell["config"])
    mix = bench.load_mix(bench.HERE, cell["traffic"])
    world = int(cfg.get("ranks", 1))
    spec = {"cfg": cfg, "mix": mix, "seed": seed, "seconds": seconds,
            "trace": bool(trace), "device": device, "backend": backend,
            "plant": plant}
    if world == 1:
        ranks = [cellmod.rank_main(0, 1, spec)]
    else:
        if device == "cuda":
            from repro_torch.kernels import _build
            _build.build([cellmod.KERNEL_LIB[cfg["kernel"]]])
        ranks = cellmod.spawn_ranks(world, spec)
    return assemble(b, cell, ranks, trace, t_start, device)


def record(ranks: list) -> "Run":
    """What the per-layer metrics read, from the ranks' results."""
    r0 = ranks[0]
    return Run(products=r0["products"],
               product_s=r0["window_s"] / r0["products"], chips=len(ranks),
               work=r0["work"], spans=r0.get("spans", []),
               traces=[r["trace"] for r in ranks if r.get("trace")],
               build_s=[r["build_s"] for r in ranks],
               counters=[r["counters"] for r in ranks if "counters" in r],
               program=r0.get("program"))


def assemble(b: dict, cell: dict, ranks: list, trace: bool,
             t_start: float, device: str) -> dict:
    r0 = ranks[0]
    run_ = record(ranks)
    products, product_s = run_.products, run_.product_s
    metrics = {}
    if trace:
        for m in bench.metrics_of(b, cell, "per_layer"):
            v = bench.load_metric(bench.HERE, m["name"]).read(run_)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"product_s": product_s, "setup_s": r0["setup_end"] - t_start}
        for m in bench.metrics_of(b, cell, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    checks = r0["checks"]
    correct = r0["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": r0["device_name"], "count": len(ranks),
           "memory_peak_bytes": max(r["memory_peak"] for r in ranks)}
    out = {"correct": bool(correct), "attempted": products,
           "failed": r0["failed"], "metrics": metrics, "device": dev}
    if trace and run_.traces:
        dev["busy_s"] = sum(t.busy_s for t in run_.traces) / len(run_.traces)
        dev["window_s"] = sum(t.window_s for t in run_.traces) / len(
            run_.traces)
        t = run_.traces[0]
        gaps = sorted(t.gaps(), key=lambda g: g[0] - g[1])[:10]
        out["breakdown"] = {
            "device_ops": t.top_ops(10),
            "idle_gaps": [[sp.label_gap(run_.spans, a, b_), b_ - a]
                          for a, b_ in gaps]}
    out["checks"] = checks
    out["_diag"] = diagnostics(ranks, run_)
    out["_forbidden"] = sorted({m for r in ranks for m in r["forbidden"]})
    return out


class Run:
    """What a per-layer metric reads: ``products`` in the window,
    ``product_s`` (rank 0's window over them), ``chips``, ``work`` (one
    product's, :class:`pbench.work.Work`), ``spans`` (rank 0's host spans,
    :mod:`pbench.spans`), ``build_s`` (each rank's mean seconds to build
    an input in set-up), ``traces`` (each rank's
    :class:`pbench.devtrace.DeviceTrace`; empty without a device trace),
    ``counters`` (each rank's mesh counters over the window, bytes;
    empty without a mesh engine) and ``program`` (rank 0's records of the
    program, :func:`pbench.cell.program_records`; None without
    ``--trace 1``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def diagnostics(ranks: list, run_: Run) -> dict:
    """Numbers for standard error: how the window went, not metrics."""
    r0 = ranks[0]
    times = sorted(r0["times"])
    least, bound = least_s(run_.work, run_.chips)
    return {"products": run_.products,
            "product_min_median_max_s": [times[0], times[len(times) // 2],
                                         times[-1]],
            "product_s_each": [round(t, 4) for t in r0["times"]],
            "gc_count_s": r0["gc"], "cpu_s": r0["cpu_s"],
            "rss_growth_bytes": [r["rss_growth"] for r in ranks],
            "builds_s": [r["builds"] for r in ranks],
            "check_s": r0.get("check_s"), "checked": r0.get("checked"),
            "work": {"pairs": run_.work.pairs,
                     "c_blocks": run_.work.c_blocks,
                     "input_blocks": run_.work.input_blocks,
                     "flops": run_.work.flops, "bytes": run_.work.bytes,
                     "least_s": least, "bound": bound,
                     "peak_flops": FP32_3XTF32_FLOPS},
            "counters": run_.counters[:1]}


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.time() if t_start is None else t_start
    args = parse(argv)
    root = pathlib.Path.cwd()
    for k, v in CACHE_DIRS.items():
        os.environ[k] = str(root / v)
    b = bench.load_benchmark(root)
    cell = bench.find_cell(b, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(root, args.workload, args.seed, args.seconds, bool(args.trace),
              t_start)
    return finish(out)


def finish(out: dict) -> int:
    """The import guard, then the result: a module of JAX or of the JAX
    package loaded here or in a rank once the window has closed fails the
    run, which then prints no result."""
    bad = sorted(set(guard.forbidden_loaded()) | set(out.pop("_forbidden")))
    if bad:
        print(f"portbench: modules of JAX or of the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    emit(out)
    return 0


def emit(out: dict) -> None:
    """Print the result: diagnostics and the checks on standard error
    (the checks last), then the line on standard output."""
    diag = out.pop("_diag")
    print("portbench: " + json.dumps(diag), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
