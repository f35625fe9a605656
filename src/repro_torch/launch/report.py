"""Collate dry-run JSONs into the EXPERIMENTS.md §Dry-run/§Roofline tables.

    PYTHONPATH=src python -m repro_torch.launch.report experiments/dryrun

Passing a file instead of a directory renders it as a summary table:
a ``BENCH_mesh_comm.json`` artifact becomes the measured-communication
table, and any unified-metrics JSON (DESIGN.md §8 schema, as produced
by ``MetricSet.to_dict()`` / ``Plan.profile()``) becomes a per-counter
table.

    PYTHONPATH=src python -m repro_torch.launch.report BENCH_mesh_comm.json
"""
from __future__ import annotations

import json
import pathlib
import sys


def load(outdir) -> list[dict]:
    rows = []
    for p in sorted(pathlib.Path(outdir).glob("*.json")):
        rows.append(json.loads(p.read_text()))
    return rows


def fmt_mem(r) -> str:
    m = r["mem"]
    return (f"{m['argument_bytes']/2**30:.2f}+{m['temp_bytes']/2**30:.2f}"
            f"={m['peak_bytes']/2**30:.2f}")


def dryrun_table(rows) -> str:
    out = ["| arch | shape | mesh | compile | mem/dev GiB (args+temps) | "
           "collectives (counts) |",
           "|---|---|---|---|---|---|"]
    for r in rows:
        cc = r.get("collective_counts") or {}
        cs = ", ".join(f"{k.replace('collective-','c-')}:{v}"
                       for k, v in cc.items()) or "-"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['t_compile_s']:.0f}s | {fmt_mem(r)} | {cs} |")
    return "\n".join(out)


def roofline_table(rows) -> str:
    out = ["| arch | shape | t_comp ms | t_mem ms | t_coll ms | bound | "
           "model GF | useful | MFU bound |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != "16x16" or "roofline" not in r:
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{rf['t_compute_s']*1e3:.2f} | {rf['t_memory_s']*1e3:.2f} | "
            f"{rf['t_collective_s']*1e3:.2f} | {rf['bottleneck']} | "
            f"{rf['model_gflops']:.0f} | "
            f"{rf['useful_fraction']*100:.0f}% | "
            f"{rf['mfu_bound']*100:.1f}% |")
    return "\n".join(out)


def metrics_table(metric_sets) -> str:
    """Unified-metrics schema (DESIGN.md §8) -> one markdown table.

    Accepts ``MetricSet`` objects or their ``to_dict()`` documents; a
    ``Plan.profile()`` document's ``metrics`` list works directly.
    """
    out = ["| source | counter | unit | total | max/worker | workers |",
           "|---|---|---|---|---|---|"]
    for ms in metric_sets:
        doc = ms.to_dict() if hasattr(ms, "to_dict") else ms
        for c in doc["counters"]:
            pw = c["per_worker"]
            out.append(
                f"| {doc['source']} | {c['name']} | {c['unit']} | "
                f"{c['total']:g} | {max(pw):g} | {len(pw)} |")
    return "\n".join(out)


def mesh_comm_table(doc) -> str:
    """BENCH_mesh_comm.json artifact -> measured-communication table."""
    out = ["| scheme | p | N | max fetched B/dev | max collective B/dev "
           "| waves |",
           "|---|---|---|---|---|---|"]
    for r in doc["records"]:
        if r["scheme"] == "mesh":
            out.append(
                f"| mesh | {r['p']} | {r['n']} | "
                f"{r['max_fetched_bytes_per_dev']} | "
                f"{r['max_collective_bytes_per_dev']} | {r['waves']} |")
        else:
            out.append(
                f"| summa | {r['p']} | {r['n']} | - | "
                f"{r['coll_bytes_per_dev']} | pgrid {r['pgrid']} |")
    out.append("")
    out.append(f"mesh fetch growth 2->8 devs: "
               f"{doc['mesh_fetch_growth_2_to_8']:.2f}x "
               f"(flat within 2x: {doc['flat_2_to_8']}); "
               f"SpSUMMA collective growth 4->16 devs: "
               f"{doc['summa_coll_growth_4_to_16']:.2f}x")
    return "\n".join(out)


def serve_table(doc) -> str:
    """BENCH_serve.json artifact -> serving throughput/latency table."""
    out = ["| max_inflight | req/s | p50 ms | p95 ms | p99 ms | hit rate "
           "| merged waves | solo waves |",
           "|---|---|---|---|---|---|---|---|"]
    for r in doc["rows"]:
        out.append(
            f"| {r['max_inflight']} | {r['requests_per_s']:.1f} | "
            f"{r['p50_ms']:.1f} | {r['p95_ms']:.1f} | {r['p99_ms']:.1f} | "
            f"{r['hit_rate']*100:.0f}% | {r['merged_waves']} | "
            f"{r['solo_waves']} |")
    p = doc.get("params", {})
    out.append("")
    out.append(f"{doc['rows'][0]['requests']} requests, "
               f"n={p.get('n')}, {p.get('n_sessions')} sessions; "
               f"results pinned to serial per-plan execution")
    return "\n".join(out)


def fault_table(doc) -> str:
    """BENCH_fault.json artifact -> recovery-policy comparison table."""
    out = ["| pattern | policy | failures | degradation | recomputed "
           "| chunks lost | re-replicated B |",
           "|---|---|---|---|---|---|---|"]
    for r in doc["rows"]:
        out.append(
            f"| {r['pattern']} | {r['policy']} | {r['n_failures']} | "
            f"{r['degradation']:.2f}x | "
            f"{r['tasks_recomputed']}/{r['n_tasks']} | "
            f"{r['chunks_lost']} | {r['bytes_rereplicated']} |")
    p = doc.get("params", {})
    out.append("")
    out.append(f"p={p.get('p')}, replicas={p.get('replicas')}, "
               f"kills at {p.get('kill_at')} of the fault-free makespan; "
               f"every cell's result is bitwise identical to fault-free")
    return "\n".join(out)


def solvers_table(doc) -> str:
    """BENCH_solvers.json artifact -> factorization + chain tables."""
    out = ["| pattern | method | iters | residual | flops | mult tasks "
           "| comm demand B |",
           "|---|---|---|---|---|---|---|"]
    for r in doc["factor_rows"]:
        out.append(
            f"| {r['pattern']} | {r['method']} | {r['iterations']} | "
            f"{r['residual']:.2e} | {r['flops']:.3g} | "
            f"{r['multiply_tasks']} | {r['comm_demand_bytes']} |")
    out.append("")
    out.append("| chain target | accumulated bound | measured error "
               "| flops | pruned flops |")
    out.append("|---|---|---|---|---|")
    for r in doc["chain_rows"]:
        out.append(
            f"| {r['target']:g} | {r['accumulated_bound']:.2e} | "
            f"{r['measured_error']:.2e} | {r['flops']:.3g} | "
            f"{r['pruned_flops']:.3g} |")
    p = doc.get("params", {})
    out.append("")
    out.append(f"n={p.get('n')}, leaf_n={p.get('leaf_n')}, "
               f"bs={p.get('bs')}; every residual matched the dense "
               f"readback, localized touched fewer subtrees than global "
               f"on every pattern, and chain error <= bound <= target")
    return "\n".join(out)


def main() -> None:
    target = pathlib.Path(sys.argv[1] if len(sys.argv) > 1
                          else "experiments/dryrun")
    if target.is_file():
        doc = json.loads(target.read_text())
        if doc.get("bench") == "mesh_comm":
            print(f"## Measured mesh communication ({target.name})\n")
            print(mesh_comm_table(doc))
        elif doc.get("bench") == "serve":
            print(f"## Plan serving ({target.name})\n")
            print(serve_table(doc))
        elif doc.get("bench") == "fault":
            print(f"## Fault recovery ({target.name})\n")
            print(fault_table(doc))
        elif doc.get("bench") == "solvers":
            print(f"## Solver suite ({target.name})\n")
            print(solvers_table(doc))
        elif "counters" in doc:
            print(f"## Metrics ({target.name})\n")
            print(metrics_table([doc]))
        elif "metrics" in doc:       # a Plan.profile() document
            print(f"## Plan profile metrics ({target.name})\n")
            print(metrics_table(doc["metrics"]))
        else:
            sys.exit(f"unrecognized report input: {target}")
        return
    rows = load(target)
    print(f"## Dry-run ({len(rows)} cells)\n")
    print(dryrun_table(rows))
    print("\n## Roofline (single-pod 16x16)\n")
    print(roofline_table(rows))


if __name__ == "__main__":
    main()
