"""Fault tolerance: heartbeats, failure detection, checkpoint/restart,
straggler mitigation.

On a real 1000+-node deployment the SPMD job cannot absorb a node loss in
place: the runtime's job is (a) to *detect* failures/stragglers fast, (b)
to bound lost work via frequent async checkpoints, and (c) to restart —
possibly on fewer nodes (elastic re-shard, runtime/elastic.py).  This
module implements that control loop in a hardware-independent way:

* ``HeartbeatMonitor`` — per-worker last-seen timestamps; a worker silent
  for ``timeout`` is declared failed; a worker whose step time exceeds
  ``straggler_factor`` x the fleet median is flagged a straggler (the
  launcher's response: exclude-and-rescale or swap-in a hot spare);
* ``FaultInjector`` — deterministic failure schedule for tests/drills
  (fail worker w at step s);
* ``TrainingRunner`` — the restartable training loop: checkpoint every
  ``ckpt_every``, on failure restore the latest committed checkpoint and
  continue (on a re-planned mesh if the world shrank).

The port of ``repro/runtime/fault.py``, copied as it is with the port's
:class:`~repro_torch.checkpoint.CheckpointManager`; the train step that
``TrainingRunner`` drives is ``launch/train.py``'s.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager


class WorkerFailure(RuntimeError):
    def __init__(self, worker: int, step: int):
        super().__init__(f"worker {worker} failed at step {step}")
        self.worker = worker
        self.step = step


@dataclasses.dataclass
class HeartbeatMonitor:
    """Per-worker liveness/straggler detection over an injectable clock.

    ``clock`` defaults to wall time (:func:`time.monotonic`); the runtime
    simulator passes its own callable so heartbeats, timeouts and
    straggler detection can all be driven in *virtual* time.
    """
    n_workers: int
    timeout: float = 30.0
    straggler_factor: float = 2.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self.last_seen = np.full(self.n_workers, now)
        self.step_times: list[list[float]] = [[] for _ in
                                              range(self.n_workers)]

    def beat(self, worker: int, step_time: Optional[float] = None):
        self.last_seen[worker] = self.clock()
        if step_time is not None:
            self.step_times[worker].append(step_time)

    def failed_workers(self) -> list[int]:
        now = self.clock()
        return [w for w in range(self.n_workers)
                if now - self.last_seen[w] > self.timeout]

    def stragglers(self) -> list[int]:
        recent = [np.mean(t[-5:]) if t else np.nan
                  for t in self.step_times]
        # before any worker reports a step time every entry is NaN and
        # np.nanmedian would emit an "All-NaN slice" RuntimeWarning
        if not any(np.isfinite(r) for r in recent):
            return []
        med = np.nanmedian(recent)
        if not np.isfinite(med):
            return []
        return [w for w, t in enumerate(recent)
                if np.isfinite(t) and t > self.straggler_factor * med]


@dataclasses.dataclass
class FaultInjector:
    """Deterministic failure schedule: raises WorkerFailure when reached.

    ``fail_at`` is a list of ``(step, worker)`` pairs with one-shot pop
    semantics: each entry fires exactly once, soonest step first, so two
    failures at the *same* step are expressible — the first ``check(s)``
    raises the first entry and the restarted run's next ``check(s)``
    raises the second.  The legacy ``{step: worker}`` dict form is still
    accepted (it can hold at most one failure per step).
    """
    fail_at: Any

    def __post_init__(self):
        pairs = (self.fail_at.items() if isinstance(self.fail_at, dict)
                 else self.fail_at)
        self._schedule = sorted((int(s), int(w)) for s, w in pairs)

    @property
    def schedule(self) -> list:
        """Remaining ``(step, worker)`` failures, soonest first."""
        return list(self._schedule)

    def check(self, step: int):
        if self._schedule and self._schedule[0][0] == step:
            s, w = self._schedule.pop(0)
            raise WorkerFailure(w, s)


@dataclasses.dataclass
class TrainingRunner:
    """Restartable loop: step_fn is pure (state, batch) -> (state, metrics).

    ``state`` is any pytree (params+opt).  ``batch_fn(step)`` supplies the
    batch — stateless access lets a restart resume mid-stream exactly
    (data/pipeline.py contract).
    """
    step_fn: Callable
    batch_fn: Callable
    ckpt: CheckpointManager
    ckpt_every: int = 25
    max_restarts: int = 3
    injector: Optional[FaultInjector] = None
    on_restart: Optional[Callable] = None   # state <- on_restart(state)

    def run(self, state, n_steps: int) -> tuple:
        """Returns (state, history dict)."""
        history = {"loss": [], "restarts": 0, "restored_from": []}
        step = 0
        restarts = 0
        # always have a restore point (a failure before the first periodic
        # checkpoint must not resume with partially-advanced state)
        self.ckpt.save(0, (0, state), blocking=True)
        while step < n_steps:
            try:
                while step < n_steps:
                    if self.injector is not None:
                        self.injector.check(step)
                    state, metrics = self.step_fn(state,
                                                  self.batch_fn(step))
                    loss = metrics.get("loss")
                    if loss is not None:
                        history["loss"].append(float(loss))
                    step += 1
                    if step % self.ckpt_every == 0:
                        self.ckpt.save(step, (step, state))
            except WorkerFailure:
                restarts += 1
                history["restarts"] = restarts
                if restarts > self.max_restarts:
                    raise
                restored, _ = self.ckpt.restore_latest((step, state))
                step, state = restored
                step = int(np.asarray(step))
                history["restored_from"].append(step)
                if self.on_restart is not None:
                    state = self.on_restart(state)
        self.ckpt.wait()
        return state, history
