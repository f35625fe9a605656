"""The train step builder (the port of ``repro/launch/sharding.py``, its
one-device part).

``TrainStep`` builds the reference's step: gradients of ``model.loss_fn``
(accumulated over microbatches when ``auto_microbatch`` asks for them),
``clip_by_global_norm``, ``cosine_schedule`` at the optimizer's step and
``adamw_update``, in that order.  It runs on one device: ``mesh=None``, or
a mesh whose batch axes have size 1 (where the reference's ZeRO-1 shards
nothing either).  The parameter and optimizer shardings, a data axis
larger than 1, ``ServeStep`` and ``make_prefill_fn`` belong to the sharded
LM and raise ``NotImplementedError`` naming ROADMAP.md queue 1 item 8.

Unlike the reference's pure, jit-compiled step, the port's step updates
the parameters and the optimizer state in place (one leaf at a time, see
:mod:`repro_torch.optim.adamw`) and returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.optim import adamw_update, clip_by_global_norm, \
    cosine_schedule
from repro_torch.optim.adamw import tree_leaves, tree_map


def _sharding(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1 item 8 (sharding)")


def batch_axes(mesh) -> tuple:
    """The axes that shard the batch (pod + data); none without a mesh."""
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def param_shardings(cfg: ModelConfig, mesh):
    raise _sharding("param_shardings (tensor-parallel parameter shardings)")


def zero1_shardings(cfg: ModelConfig, mesh, data_axes: tuple):
    raise _sharding("zero1_shardings (optimizer moments over the data axes)")


@dataclasses.dataclass
class TrainStep:
    """Step builder for one (cfg, mesh) pair on one device.

    * ``microbatch``: gradient-accumulation factor (a loop over
      microbatches) — bounds activation memory at B/microbatch per pass;
    * ``mesh``: ``None`` or a ``torch.distributed`` DeviceMesh whose batch
      axes have size 1 (the reference's ``zero1`` shards nothing there, so
      the port has no such field).
    """
    cfg: ModelConfig
    mesh: Optional[object] = None
    microbatch: int = 0          # 0 = auto
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    clip_norm: float = 1.0

    def __post_init__(self):
        if self.mesh is not None:
            sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))
            n_data = 1
            for a in batch_axes(self.mesh):
                n_data *= sizes[a]
            if n_data > 1:
                raise _sharding(f"a train step over {n_data} data-parallel "
                                f"devices")

    def auto_microbatch(self, shape: ShapeSpec) -> int:
        """Pick accumulation so activations fit: target <= ~2 GiB of
        layer-input remat buffers per device."""
        if self.microbatch:
            return self.microbatch
        b_dev = max(1, shape.global_batch)
        cfg = self.cfg
        bytes_per_b = shape.seq_len * cfg.d_model * 2 * cfg.n_layers
        budget = 2 * 2 ** 30
        micro = 1
        while b_dev // micro > 1 and (b_dev // micro) * bytes_per_b > budget:
            micro *= 2
        return min(micro, b_dev)

    def step_fn(self, shape: Optional[ShapeSpec] = None):
        cfg = self.cfg
        micro = self.auto_microbatch(shape) if shape is not None else 1
        if cfg.cost_mode:
            micro = 1      # cost compiles measure one full-batch pass

        def grads_of(params, batch):
            # aliases that record autograd, so the caller's tensors stay
            # plain (the update below writes them in place)
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, metrics = M.loss_fn(cfg, live, batch)
            grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
            return loss.detach(), metrics, tree_map(lambda _: next(grads),
                                                    params)

        def step(params, opt_state, batch):
            if micro <= 1:
                loss, metrics, grads = grads_of(params, batch)
                metrics = {k: v.detach() for k, v in metrics.items()}
            else:
                def split(x):
                    x = torch.as_tensor(x)
                    return x.reshape(micro, x.shape[0] // micro,
                                     *x.shape[1:])

                mb = {k: split(v) for k, v in batch.items()}
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)
                loss = torch.zeros((), dtype=torch.float32,
                                   device=tree_leaves(params)[0].device)
                for i in range(micro):
                    li, _, gi = grads_of(params,
                                         {k: v[i] for k, v in mb.items()})
                    for a, g in zip(tree_leaves(grads), tree_leaves(gi)):
                        a.add_(g.float())
                    loss = loss + li
                for g in tree_leaves(grads):
                    g.div_(micro)
                loss = loss / micro
                metrics = {}
            grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
            lr = cosine_schedule(opt_state.step, peak_lr=self.peak_lr,
                                 warmup=self.warmup, total=self.total_steps)
            params, opt_state = adamw_update(params, grads, opt_state, lr=lr)
            metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
            return params, opt_state, metrics

        return step


class ServeStep:
    """Not ported: the sharded decode step (queue 1 item 8)."""

    def __init__(self, *args, **kwargs):
        raise _sharding("ServeStep (the sharded decode step)")


def make_prefill_fn(cfg: ModelConfig, mesh):
    raise _sharding("make_prefill_fn (the sharded prefill)")
