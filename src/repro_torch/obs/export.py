"""Exporters: Chrome trace-event JSON (Perfetto-loadable) + text report.

Everything here emits the Trace Event Format that ``chrome://tracing``
and https://ui.perfetto.dev load directly: a ``{"traceEvents": [...]}``
object whose events are complete slices (``"ph": "X"`` with ``ts``/
``dur`` in microseconds), counter samples (``"ph": "C"``) and metadata
rows (``"ph": "M"``) naming processes/threads.  Three sources export:

* :func:`sim_trace_events` — the runtime simulator's
  :class:`~repro_torch.runtime.trace.Trace`: one *process* ("simulator"),
  workers as threads/tracks, every simulated task as a slice carrying
  its communication attributes, plus per-worker cumulative
  ``bytes_received`` counter tracks (the Figs 11-13 quantity over time);
* :func:`span_events` — a recording :class:`~repro_torch.obs.tracer.Tracer`:
  each span track as a thread, spans as slices (nesting renders
  natively since child slices sit inside their parents' intervals) with
  their ids, parents and steps, and the tracer's running counters as
  counter samples;
* :func:`mesh_stats_events` — a mesh engine :meth:`stats` dict:
  devices as threads, waves as slices laid out on the measured
  cumulative wall clock, with per-device counter tracks for the
  measured fetched/pushed/collective bytes.  It reads the dict alone,
  as :meth:`repro_torch.launch.mesh_exec.MeshEngine.stats` returns it.

All assemblers sort events by timestamp (tests assert monotonicity) and
:func:`write_chrome_trace` writes the loadable file.
"""
from __future__ import annotations

import json
import pathlib
from typing import Optional

from .metrics import MetricSet

__all__ = ["sim_trace_events", "span_events", "mesh_stats_events",
           "chrome_trace", "write_chrome_trace", "text_report"]

#: stable process ids per source so combined traces don't collide
PID_SPANS, PID_SIM, PID_MESH = 0, 1, 2


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> list[dict]:
    ev = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
           "args": {"name": name}}]
    if tid is not None:
        ev.append({"name": "thread_name", "ph": "M", "pid": pid,
                   "tid": tid, "args": {"name": tname}})
    return ev


def sim_trace_events(trace, counters: bool = True) -> list[dict]:
    """Trace events of one simulated phase: workers as tracks.

    ``trace`` is a :class:`~repro_torch.runtime.trace.Trace`; virtual seconds
    map to trace microseconds.  With ``counters=True`` each worker also
    gets a cumulative ``bytes_received`` counter track sampled at every
    task completion.
    """
    events: list[dict] = _meta(PID_SIM, "simulator (virtual time)")
    for w in range(trace.n_workers):
        events += _meta(PID_SIM, "", w, f"worker {w}")[1:]
    received = [0] * trace.n_workers
    for ev in trace.events:
        events.append({
            "name": ev.kind, "ph": "X", "pid": PID_SIM, "tid": ev.worker,
            "ts": ev.start * 1e6, "dur": max(ev.end - ev.start, 0.0) * 1e6,
            "args": {"nid": ev.nid, "stolen": ev.stolen,
                     "remote_bytes": ev.remote_bytes,
                     "remote_msgs": ev.remote_msgs,
                     "pushed_bytes": ev.pushed_bytes},
        })
        if counters:
            received[ev.worker] += ev.remote_bytes
            events.append({
                "name": f"bytes_received w{ev.worker}", "ph": "C",
                "pid": PID_SIM, "tid": ev.worker, "ts": ev.end * 1e6,
                "args": {"bytes": received[ev.worker]},
            })
    return events


def span_events(tracer) -> list[dict]:
    """Trace events of a recording tracer: span tracks as threads.

    Each slice's args are the span's attributes plus ``span_id``,
    ``parent_id`` and ``step`` (named so that no attribute is shadowed);
    each of ``tracer.counters`` becomes one counter sample (``"ph": "C"``)
    of its running total at the end of the last span."""
    events: list[dict] = _meta(PID_SPANS, "spans (wall time)")
    tids: dict[str, int] = {}
    t_end = 0.0
    for sp in tracer.ordered():
        tid = tids.get(sp.track)
        if tid is None:
            tid = tids[sp.track] = len(tids)
            events += _meta(PID_SPANS, "", tid, sp.track)[1:]
        events.append({
            "name": sp.name, "ph": "X", "pid": PID_SPANS, "tid": tid,
            "ts": sp.t0 * 1e6, "dur": max(sp.duration, 0.0) * 1e6,
            "args": dict(sp.attrs, span_id=sp.id, parent_id=sp.parent,
                         step=sp.step),
        })
        t_end = max(t_end, sp.t1)
    for name, v in sorted(tracer.counters.items()):
        events.append({"name": name, "ph": "C", "pid": PID_SPANS, "tid": 0,
                       "ts": t_end * 1e6, "args": {"value": v}})
    return events


def mesh_stats_events(stats: dict) -> list[dict]:
    """Trace events of a mesh run: devices as tracks, waves as slices.

    Wave slices are laid out sequentially on the measured cumulative
    wall clock (``wall_s`` per wave).  When the per-wave counter deltas
    are present in ``comm_log`` (``fetched_bytes_by_dev`` etc.), each
    device gets cumulative counter tracks of the measured bytes — the
    Table-1 metric over time.
    """
    n_dev = int(stats.get("n_dev") or 0)
    events: list[dict] = _meta(PID_MESH, "mesh devices (measured)")
    for d in range(n_dev):
        events += _meta(PID_MESH, "", d, f"device {d}")[1:]
    cum = {"fetched_bytes": [0] * n_dev, "pushed_bytes": [0] * n_dev,
           "collective_bytes": [0] * n_dev}
    t = 0.0
    waves = stats.get("wave_log", [])
    comm = stats.get("comm_log", [])
    for i, w in enumerate(waves):
        c = comm[i] if i < len(comm) else {}
        dur = float(w.get("wall_s", 0.0))
        for d in range(n_dev):
            events.append({
                "name": f"wave {i} (bs={w.get('bs')})", "ph": "X",
                "pid": PID_MESH, "tid": d, "ts": t * 1e6, "dur": dur * 1e6,
                "args": {k: w[k] for k in ("kernel", "tasks", "pairs",
                                           "padded_pairs", "c_blocks")
                         if k in w},
            })
            for key in cum:
                deltas = c.get(f"{key}_by_dev")
                if deltas is None:
                    continue
                cum[key][d] += deltas[d]
                events.append({
                    "name": f"{key} d{d}", "ph": "C", "pid": PID_MESH,
                    "tid": d, "ts": (t + dur) * 1e6,
                    "args": {"bytes": cum[key][d]},
                })
        t += dur
    return events


def chrome_trace(*event_lists) -> dict:
    """Assemble event lists into one loadable trace object.

    Metadata events sort first (ts 0); slice/counter events are sorted
    by timestamp so the stream is monotone (asserted by tests).
    """
    meta, timed = [], []
    for evs in event_lists:
        for ev in evs:
            (meta if ev.get("ph") == "M" else timed).append(ev)
    timed.sort(key=lambda ev: ev["ts"])
    return {"traceEvents": meta + timed, "displayTimeUnit": "ms"}


def write_chrome_trace(path, *event_lists) -> pathlib.Path:
    """Write a ``.trace.json`` file Perfetto/chrome://tracing can load.

    Accepts raw event lists or an already-assembled trace object.
    """
    if len(event_lists) == 1 and isinstance(event_lists[0], dict):
        obj = event_lists[0]
    else:
        obj = chrome_trace(*event_lists)
    path = pathlib.Path(path)
    path.write_text(json.dumps(obj, indent=1, sort_keys=True) + "\n")
    return path


def text_report(*metric_sets, title: str = "metrics") -> str:
    """Compact fixed-width table of one or more :class:`MetricSet`."""
    lines = [f"== {title} =="]
    for ms in metric_sets:
        if not isinstance(ms, MetricSet):
            ms = MetricSet.from_dict(ms)
        if ms.source:
            lines.append(f"-- {ms.source}")
        lines.append(f"{'counter':<22} {'unit':<7} {'total':>14} "
                     f"{'max/worker':>14} {'workers':>8}")
        for c in ms:
            tot = f"{c.total:.6g}" if isinstance(c.total, float) \
                else f"{c.total}"
            mx = f"{c.max:.6g}" if isinstance(c.max, float) else f"{c.max}"
            lines.append(f"{c.name:<22} {c.unit:<7} {tot:>14} {mx:>14} "
                         f"{len(c.per_worker):>8}")
    return "\n".join(lines)
