"""Cross-plan wave coalescer: one fused kernel launch for many plans.

The deferred engine already batches *within* a graph: every pending leaf
task whose operands are final joins one fused ``bsmm_pairs`` /
``batched_gemm`` launch at flush.  A serving front end runs several
plans per batch — possibly in *different* sessions, each with its own
engine — and flushing them one by one would launch one undersized wave
per plan.  :class:`WaveCoalescer` instead:

1. asks every engine for its ready kernel tasks grouped by
   :meth:`~repro_torch.core.engine.TorchEngine.batch_key`
   (``(kernel, leaf_n, bs, dtype)``),
2. merges groups with equal keys across engines on the same device,
3. packs each merged group through the same
   :func:`~repro_torch.core.engine.dispatch_packed_wave` the engines use
   themselves — one kernel launch per key per round — and
4. commits each engine's share back so its wave log and pending set stay
   consistent.

Numerical identity with per-plan flushing is structural, not accidental:
output slots are numbered task-by-task, pair order within a task is
preserved, and the segment sort is stable — so every output block
accumulates exactly the pair products it would have accumulated alone,
in the same order, in float32 (see ``dispatch_packed_wave``).  On the
card this holds for ``kernel="pairs"``: each ``bsmm_pairs`` output slot
is summed by one team from its own run of pairs.  Under ``kernel="gemm"``
the segment sum is ``index_add_``, whose CUDA atomics add in no fixed
order, so there a coalesced wave agrees with per-plan flushing to
float32 rounding only.  Tests pin the pairs route bitwise.

Only plain :class:`~repro_torch.core.engine.TorchEngine` instances
merge, and only with engines on the same device; the immediate numpy
backend flushes through its own path.
"""
from __future__ import annotations

from repro_torch.core.engine import TorchEngine, dispatch_packed_wave
from repro_torch.obs.metrics import MetricSet
from repro_torch.obs.tracer import NOOP

__all__ = ["WaveCoalescer"]


class WaveCoalescer:
    """Merge compatible ready waves across engines, dispatch once."""

    def __init__(self, tracer=NOOP):
        self.tracer = tracer
        # merged-wave log: one record per fused dispatch this coalescer ran
        self.waves: list[dict] = []
        self.merged_waves = 0       # dispatches serving >1 engine
        self.solo_waves = 0         # dispatches serving exactly 1 engine
        self.merged_tasks = 0       # tasks that shared a cross-engine wave

    # -- the batch flush ------------------------------------------------------
    def flush(self, graphs) -> int:
        """Drain all deferred work of ``graphs``, coalescing across them.

        Returns the number of fused dispatches run.  Engines that cannot
        merge (numpy/immediate) are flushed through their own ``flush``
        unchanged.
        """
        mergeable: list[tuple] = []     # (graph, engine)
        rest: list = []
        for g in graphs:
            eng = g._engine
            # exactly TorchEngine: a subclass may own device state a
            # foreign dispatch would bypass
            if type(eng) is TorchEngine:
                mergeable.append((g, eng))
            else:
                rest.append(g)
        for g in rest:
            g.flush()
        dispatches = 0
        while True:
            progressed = False
            for g, eng in mergeable:
                eng._bind(g)
                progressed |= eng.run_host_ready()
                # solve waves (triangular kinds) stay per-engine: they
                # dispatch dense stacked leaves, not GEMM pair streams
                progressed |= eng.run_solve_ready()
            merged: dict = {}
            for _, eng in mergeable:
                for key, tasks in eng.ready_wave().items():
                    # two devices never share a wave
                    merged.setdefault((key, eng.device), []).append(
                        (eng, tasks))
            for (key, device), parts in sorted(
                    merged.items(), key=lambda kv: kv[0][0]):
                self._dispatch(key, device, parts)
                dispatches += 1
                progressed = True
            if not any(eng._pending for _, eng in mergeable):
                break
            if not progressed:
                raise RuntimeError(
                    "wave coalescer deadlock: unresolvable leaf "
                    "dependencies across in-flight plans")
        return dispatches

    def _dispatch(self, key: tuple, device, parts: list) -> None:
        kernel, _, bs, _ = key
        all_tasks = [t for _, tasks in parts for t in tasks]
        with self.tracer.span("serve.wave", track="serve",
                              engines=len(parts), tasks=len(all_tasks),
                              kernel=kernel, bs=bs):
            record = dispatch_packed_wave(
                all_tasks, bs, kernel=kernel, device=device,
                tracer=self.tracer)
        record["batch_key"] = list(key)
        record["engines"] = len(parts)
        self.waves.append(record)
        if len(parts) > 1:
            self.merged_waves += 1
            self.merged_tasks += len(all_tasks)
        else:
            self.solo_waves += 1
        # each engine keeps its own share of the accounting: pair/task/
        # block counts are exact, wall time and bytes are attributed
        # proportionally by pair count so per-engine stats() still sum
        # to (approximately) the merged wave
        total_pairs = max(record["pairs"], 1)
        for eng, tasks in parts:
            pe_pairs = sum(t.n_pairs for t in tasks)
            share = pe_pairs / total_pairs
            eng.commit_tasks(tasks, wave_record={
                "kernel": kernel, "bs": bs, "tasks": len(tasks),
                "pairs": int(pe_pairs), "padded_pairs": int(pe_pairs),
                "c_blocks": sum(len(t.out.blocks) for t in tasks),
                "wall_s": record["wall_s"] * share,
                "bytes_packed": int(record["bytes_packed"] * share),
                "batch_key": list(key), "coalesced": len(parts),
            })

    # -- reporting ------------------------------------------------------------
    def counters(self) -> dict:
        return {"merged_waves": self.merged_waves,
                "solo_waves": self.solo_waves,
                "merged_tasks": self.merged_tasks,
                "dispatches": len(self.waves)}

    def metrics(self) -> MetricSet:
        ms = MetricSet(source="serve-coalescer")
        for k, v in self.counters().items():
            ms.add(k, "count", [v])
        return ms

    def __repr__(self) -> str:
        return (f"WaveCoalescer(dispatches={len(self.waves)}, "
                f"merged={self.merged_waves}, solo={self.solo_waves})")
