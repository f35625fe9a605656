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
        return {k: torch.as_tensor(v, device=device)
                for k, v in data.batch_at(step).items()}

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
