"""Training driver (the port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --smoke --steps 50 --batch 8 --seq 128 [--device cpu]

``--smoke`` selects the reduced config; without it the full config is
used.  The model trains on the card unless ``--device`` names another
device.  The loop is the fault-tolerant ``TrainingRunner``: async
checkpoints, restart on failure, an optional failure drill
(``--drill-fail-step``), the step time of each step reported to a
heartbeat monitor.  ``--compress-grads`` is kept as the reference has it:
it wraps the step without calling ``compressed_grad_tree``, so it changes
nothing.  Without ``--ckpt-dir`` the checkpoints go to a fresh temporary
directory, removed at the end (the reference's default, a fixed
``/tmp/repro_ckpt``, lets a later run restore an earlier run's steps).
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.launch.sharding import TrainStep
from repro_torch.models import model as M
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import adamw_init
from repro_torch.runtime import (FaultInjector, HeartbeatMonitor,
                                 TrainingRunner)


def train_batch(cfg, data: SyntheticLM, step: int, batch: int,
                seq: int) -> dict:
    """The driver's batch at ``step`` as numpy arrays, before the cast
    (:func:`batch_to`): token batches from ``data``; the audio frontend's
    frames and targets, and the VLM frontend's patches, drawn from
    ``np.random.default_rng(step)``, the VLM's text cut to its first
    ``seq - n_patches`` tokens, as the reference's driver does."""
    if cfg.frontend == "frames":
        rng = np.random.default_rng(step)
        return {
            "frames": rng.standard_normal((batch, seq, cfg.d_model)),
            "targets": rng.integers(0, cfg.vocab, (batch, seq)),
        }
    b = data.batch_at(step)
    if cfg.frontend == "patches":
        rng = np.random.default_rng(step)
        s_text = seq - cfg.n_patches
        return {
            "tokens": b["tokens"][:, :s_text],
            "patches": rng.standard_normal(
                (batch, cfg.n_patches, cfg.d_model)),
            "targets": b["targets"][:, :s_text],
        }
    return b


def batch_to(cfg, batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``: float fields in the
    config's type, integer fields int32 (the reference's casts)."""
    return {k: torch.as_tensor(
        v, dtype=cfg.torch_dtype if np.issubdtype(v.dtype, np.floating)
        else torch.int32, device=device) for k, v in batch.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--drill-fail-step", type=int, default=0,
                    help="inject a worker failure at this step (drill)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device to train on (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else \
        get_config(args.arch)
    device = resolve_device(args.device)
    shape = ShapeSpec("cli", "train", args.seq, args.batch)

    builder = TrainStep(cfg, peak_lr=args.lr, warmup=10,
                        total_steps=args.steps)
    params = M.init_params(cfg, torch.Generator(device).manual_seed(
        args.seed), device=device)
    opt = adamw_init(params)
    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed)

    step_fn = builder.step_fn(shape)
    if args.compress_grads:
        base = step_fn

        def step_fn(params, opt_state, batch):  # noqa: F811
            # the reference's flag, kept as it is: the int8 round trip on
            # the DP wire (runtime/compression.py) is not applied
            return base(params, opt_state, batch)

    monitor = HeartbeatMonitor(n_workers=1)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    ckpt = CheckpointManager(ckpt_dir, keep=2)
    injector = FaultInjector({args.drill_fail_step: 0}) \
        if args.drill_fail_step else None

    def batch_fn(step):
        return batch_to(cfg, train_batch(cfg, data, step, args.batch,
                                         args.seq), device)

    def run_step(state, batch):
        t0 = time.time()
        params, opt, metrics = step_fn(state[0], state[1], batch)
        monitor.beat(0, time.time() - t0)
        return (params, opt), metrics

    runner = TrainingRunner(run_step, batch_fn, ckpt,
                            ckpt_every=args.ckpt_every, injector=injector)
    t0 = time.time()
    try:
        (params, opt), hist = runner.run((params, opt), args.steps)
    finally:
        if args.ckpt_dir is None:
            ckpt.wait()
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    dt = time.time() - t0

    losses = hist["loss"]
    print(f"arch={cfg.name} steps={len(losses)} "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({dt:.1f}s, {dt/max(len(losses),1)*1e3:.0f} ms/step, "
          f"restarts={hist['restarts']})")
    assert losses[-1] < losses[0], "loss did not decrease"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
