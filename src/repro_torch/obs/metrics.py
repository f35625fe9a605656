"""Unified counter registry: one schema for every counter family (§8).

The repo accumulated three disjoint ways of counting the paper's central
quantity (communication volume per process) plus assorted work counters:

* the simulator's :class:`~repro_torch.runtime.scheduler.SimReport` /
  ``WorkerStats`` (modelled bytes received/pushed, cache hits, flops);
* the mesh executor's *measured* per-device numpy counters
  (``fetched_bytes`` / ``pushed_bytes`` / ``collective_bytes`` — the
  Table-1 metric, launch/mesh_exec.py);
* per-feature dicts: the torch engine's wave stats and the SpAMM
  :class:`~repro_torch.core.multiply.TruncationReport`.

This module puts them all behind one shape, so benchmarks/tests/reports
assert on one schema regardless of engine::

    {"schema": 1, "source": "simulator",
     "counters": [{"name": "bytes_received", "unit": "B",
                   "per_worker": [...], "total": ...}, ...]}

``per_worker`` is the per-worker/per-device breakdown (a single-element
list for global counters); ``total`` is always its sum.  Converters are
lossless over the counter values: ``from_sim_report(rep)`` carries
exactly the lists ``rep`` carries (pinned by tests/test_obs.py), so the
unified view reproduces the legacy numbers bit-for-bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["SCHEMA_VERSION", "Counter", "MetricSet", "from_sim_report",
           "from_engine_stats", "from_truncation", "validate_metrics"]

SCHEMA_VERSION = 1


@dataclasses.dataclass
class Counter:
    """One named counter: a per-worker breakdown plus derived total."""
    name: str
    unit: str                   # "B", "blocks", "msgs", "tasks", "flop", "s"
    per_worker: list

    @property
    def total(self):
        return sum(self.per_worker)

    @property
    def max(self):
        return max(self.per_worker) if self.per_worker else 0

    def to_dict(self) -> dict:
        return {"name": self.name, "unit": self.unit,
                "per_worker": list(self.per_worker), "total": self.total}


class MetricSet:
    """Ordered registry of :class:`Counter` rows from one source."""

    def __init__(self, source: str = ""):
        self.source = source
        self._counters: dict[str, Counter] = {}

    def add(self, name: str, unit: str, per_worker) -> Counter:
        """Register a counter; a scalar becomes a one-element breakdown."""
        if isinstance(per_worker, (int, float)):
            per_worker = [per_worker]
        c = Counter(name, unit, [v for v in per_worker])
        self._counters[name] = c
        return c

    def merge(self, other: "MetricSet", prefix: str = "") -> "MetricSet":
        """Fold another set's counters in (optionally name-prefixed)."""
        for c in other:
            self.add(prefix + c.name, c.unit, c.per_worker)
        return self

    # -- mapping surface -----------------------------------------------------
    def __getitem__(self, name: str) -> Counter:
        return self._counters[name]

    def __contains__(self, name: str) -> bool:
        return name in self._counters

    def __iter__(self):
        return iter(self._counters.values())

    def __len__(self) -> int:
        return len(self._counters)

    def get(self, name: str, default=None):
        return self._counters.get(name, default)

    def names(self) -> list[str]:
        return list(self._counters)

    def __repr__(self) -> str:
        return (f"MetricSet(source={self.source!r}, "
                f"counters={self.names()})")

    # -- serialisation -------------------------------------------------------
    def to_dict(self) -> dict:
        return {"schema": SCHEMA_VERSION, "source": self.source,
                "counters": [c.to_dict() for c in self]}

    @classmethod
    def from_dict(cls, d: dict) -> "MetricSet":
        validate_metrics(d)
        ms = cls(d.get("source", ""))
        for c in d["counters"]:
            ms.add(c["name"], c["unit"], c["per_worker"])
        return ms


def validate_metrics(d: dict) -> dict:
    """Assert ``d`` has the unified metrics shape; returns it unchanged."""
    if not isinstance(d, dict) or d.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"not a metrics dict (schema={SCHEMA_VERSION}): "
                         f"{type(d)} {d if isinstance(d, dict) else ''}")
    counters = d.get("counters")
    if not isinstance(counters, list):
        raise ValueError("metrics dict missing 'counters' list")
    for c in counters:
        missing = {"name", "unit", "per_worker", "total"} - set(c)
        if missing:
            raise ValueError(f"counter {c.get('name')!r} missing {missing}")
        if sum(c["per_worker"]) != c["total"]:
            raise ValueError(
                f"counter {c['name']!r}: total {c['total']} != "
                f"sum(per_worker) {sum(c['per_worker'])}")
    return d


# ---------------------------------------------------------------------------
# Converters from the legacy counter families
# ---------------------------------------------------------------------------

def from_sim_report(rep) -> MetricSet:
    """Unified view of a :class:`~repro_torch.runtime.scheduler.SimReport`.

    The per-worker lists are carried over verbatim: ``bytes_received`` is
    the paper's cache-miss communication metric (Figs 11-13), identical
    to ``rep.bytes_received``.
    """
    ms = MetricSet("simulator")
    ms.add("bytes_received", "B", rep.bytes_received)
    ms.add("bytes_pushed", "B", rep.bytes_pushed)
    ms.add("messages_received", "msgs", rep.messages_received)
    ms.add("cache_hits", "hits", rep.cache_hits)
    ms.add("dedup_hits", "hits", rep.dedup_hits)
    ms.add("peak_owned_bytes", "B", rep.peak_owned)
    ms.add("tasks_executed", "tasks", rep.tasks_per_worker)
    ms.add("flops_executed", "flop", rep.flops_executed)
    ms.add("busy_time", "s", rep.busy_time)
    ms.add("steals", "steals", rep.steals)
    ms.add("makespan", "s", rep.makespan)
    # recovery counters (DESIGN.md §10) appear only when a fault was
    # actually injected, so fault-free metric sets — including the pinned
    # bit-for-bit artifact reproductions — keep their exact legacy shape
    if getattr(rep, "fault_events", None) or getattr(rep, "workers_failed",
                                                     None):
        ms.add("workers_failed", "workers", len(rep.workers_failed))
        ms.add("chunks_lost", "chunks", rep.chunks_lost)
        ms.add("bytes_lost", "B", rep.bytes_lost)
        ms.add("tasks_recomputed", "tasks", rep.tasks_recomputed)
        ms.add("bytes_rereplicated", "B", rep.bytes_rereplicated)
        ms.add("chunks_recovered", "chunks", rep.chunks_recovered)
    return ms


def from_engine_stats(stats: dict) -> MetricSet:
    """Unified view of a leaf engine's :meth:`stats` dict.

    Handles all three backends: the numpy engine (no wave machinery —
    an empty set tagged ``engine:numpy``), the torch engine (global
    wave/pair/padding/bytes counters) and the mesh engine (adds the
    measured per-device fetch/push/collective byte counters — the
    Table-1 numbers — carried over verbatim from
    :meth:`~repro_torch.launch.mesh_exec.MeshEngine.stats`).
    """
    ms = MetricSet(f"engine:{stats.get('backend', 'numpy')}")
    if "waves" in stats:
        ms.add("waves", "waves", stats["waves"])
        ms.add("batched_pairs", "pairs", stats["batched_pairs"])
        ms.add("padded_pairs", "pairs", stats["padded_pairs"])
        ms.add("c_blocks", "blocks", stats["c_blocks"])
        ms.add("kernel_wall_s", "s", stats["kernel_wall_s"])
        ms.add("bytes_packed", "B", stats["bytes_packed"])
    # mesh executor: measured per-device communication counters
    for name, unit in (("fetched_bytes", "B"), ("fetched_blocks", "blocks"),
                       ("pushed_bytes", "B"), ("collective_bytes", "B")):
        if name in stats:
            ms.add(name, unit, stats[name])
    return ms


def from_truncation(report) -> MetricSet:
    """Unified view of a :class:`~repro_torch.core.multiply.TruncationReport`."""
    ms = MetricSet("truncation")
    ms.add("pruned_subtrees", "subtrees", report.pruned_subtrees)
    ms.add("pruned_leaf_pairs", "pairs", report.pruned_leaf_pairs)
    ms.add("pruned_flops", "flop", report.pruned_flops)
    ms.add("error_bound", "frob", report.error_bound)
    return ms
