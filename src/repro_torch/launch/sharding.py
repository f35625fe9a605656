"""Sharding rules and the train step builder (the port of
``repro/launch/sharding.py``).

Name-based partition rules (MaxText-style logical axes, simplified):
tensor-parallel over the ``model`` axis for the big projection dims,
batch over ``data`` (+ ``pod`` when multi-pod), optional ZeRO-1 sharding
of optimizer moments over the data axis.  The port writes a partition
spec as a plain tuple over mesh axis names, one entry a dim: ``None``
(replicated), an axis name, or a tuple of names (``("pod", "data")``),
the entries of the reference's ``PartitionSpec``.  A mesh is anything
that maps axis names to sizes: a ``torch.distributed`` DeviceMesh (its
``mesh_dim_names`` and ``mesh.shape``) or a plain dict.

``TrainStep`` builds the reference's step: gradients of ``model.loss_fn``
(accumulated over microbatches when ``auto_microbatch`` asks for them),
``clip_by_global_norm``, ``cosine_schedule`` at the optimizer's step and
``adamw_update``, in that order.  On a mesh whose batch axes hold more
than one rank, each rank runs the step on its shard of the batch and the
gradients, the loss and the metrics are averaged over the batch axes
before the clip, so every rank ends the step with the same parameters and
moments (data parallelism; the moments stay replicated).  A ``model`` axis
larger than 1, ZeRO-1 placement, ``ServeStep`` and ``make_prefill_fn``
raise ``NotImplementedError`` naming ROADMAP.md queue 1 item 8 (sharding),
step 3.

Unlike the reference's pure, jit-compiled step, the port's step updates
the parameters and the optimizer state in place (one leaf at a time, see
:mod:`repro_torch.optim.adamw`) and returns them.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections.abc import Mapping
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.optim import adamw_update, clip_by_global_norm, \
    cosine_schedule
from repro_torch.optim.adamw import _slabs, tree_leaves, tree_map

MODEL_AXIS = "model"


def _sharding(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1 item 8 (sharding), "
        f"step 3")


def mesh_sizes(mesh) -> dict:
    """``{axis: size}`` of a mesh: a mapping as it is, a DeviceMesh by its
    dim names and shape; empty without a mesh."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(mesh) -> tuple:
    """The axes that shard the batch (pod + data); none without a mesh."""
    sizes = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


# ---------------------------------------------------------------------------
# spec tables
# ---------------------------------------------------------------------------

def _trailing_rule(cfg: ModelConfig, name: str, shape: tuple) -> tuple:
    """Spec entries for the trailing (non-stack) dims of a param."""
    mdl = MODEL_AXIS
    if cfg.n_experts and name in ("w_gate", "w_up", "w_down"):
        # (E, d, ff) / (E, ff, d): expert-parallel when E divides the axis,
        # else shard the ff dim inside every expert
        if name in ("w_gate", "w_up"):
            return (mdl, None, None) if cfg.n_experts % 16 == 0 \
                else (None, None, mdl)
        return (mdl, None, None) if cfg.n_experts % 16 == 0 \
            else (None, mdl, None)
    rules = {
        "embed": (mdl, None),
        "unembed": (mdl, None),
        "patch_proj": (None, None),
        "final_norm": (None,),
        "wq": (None, mdl), "wk": (None, mdl), "wv": (None, mdl),
        "wo": (mdl, None),
        "w_gate": (None, mdl), "w_up": (None, mdl), "w_down": (mdl, None),
        "w1": (None, mdl), "w2": (mdl, None),
        "router": (None, None),
        "in_proj": (None, mdl),
        "out_proj": (mdl, None),
        "x_proj": (mdl, None),
        "dt_proj": (None, mdl),
        "conv": (mdl, None),
        "norm_scale": (mdl,),
        "norm_attn": (None,), "norm_mlp": (None,), "norm_mixer": (None,),
        "dt_bias": (mdl,),
        "D": (mdl,),
    }
    if name == "A_log":
        return (mdl, None) if len(shape) >= 2 and \
            shape[-1] == cfg.ssm_state and cfg.mixer == "mamba1" else (mdl,)
    if name in rules:
        return rules[name]
    return tuple(None for _ in shape)


def _axis_size(sizes: dict, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return math.prod(sizes[a] for a in entry)
    return sizes[entry]


def _fix_spec(mesh, shape: tuple, spec: list) -> list:
    """Every sharded dim must divide its axes: move a sharded entry to
    another divisible dim, else drop it (replicate)."""
    sizes = mesh_sizes(mesh)
    spec = list(spec)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        n = _axis_size(sizes, entry)
        if shape[i] % n == 0:
            continue
        # prefer trailing dims (hd, ff, ...) as the new home
        for j in range(len(spec) - 1, -1, -1):
            if spec[j] is None and shape[j] % n == 0 and shape[j] >= n:
                spec[j] = entry
                break
        spec[i] = None
    return spec


def param_spec(cfg: ModelConfig, path: tuple, shape: tuple,
               mesh=None) -> tuple:
    """The spec of the param at ``path`` (its keys; the last one names
    it), fixed for divisibility on ``mesh`` when one is given."""
    trailing = _trailing_rule(cfg, path[-1], shape)
    lead = len(shape) - len(trailing)
    assert lead >= 0, (path[-1], shape, trailing)
    spec = [None] * lead + list(trailing)
    if mesh is not None:
        spec = _fix_spec(mesh, shape, spec)
    return tuple(spec)


def _spec_tree(shapes: dict, fn, path=()) -> dict:
    return {k: _spec_tree(v, fn, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in shapes.items()}


def param_shardings(cfg: ModelConfig, mesh) -> dict:
    """Spec tree matching the params tree."""
    return _spec_tree(M.param_shapes(cfg),
                      lambda path, shape: param_spec(cfg, path, shape, mesh))


def zero1_shardings(cfg: ModelConfig, mesh, data_axes: tuple) -> dict:
    """ZeRO-1: optimizer moments additionally sharded over the data axes on
    the first dimension the param spec leaves unsharded AND divisible
    (usually the layer stack) — each data replica owns a slice."""
    n_data = _axis_size(mesh_sizes(mesh), tuple(data_axes))

    def spec(path, shape):
        base = list(param_spec(cfg, path, shape, mesh))
        for i, (entry, dim) in enumerate(zip(base, shape)):
            if entry is None and dim % n_data == 0 and dim >= n_data:
                base[i] = data_axes if len(data_axes) > 1 else data_axes[0]
                break
        return tuple(base)

    return _spec_tree(M.param_shapes(cfg), spec)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _batch_group(mesh):
    """The process group over the batch axes of a DeviceMesh whose model
    axis is 1 (flattened when both pod and data are present)."""
    axes = batch_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return dist.new_group(mesh.mesh.flatten().tolist())


@dataclasses.dataclass
class TrainStep:
    """Step builder for one (cfg, mesh) pair.

    * ``microbatch``: gradient-accumulation factor (a loop over
      microbatches) — bounds activation memory at B_device/microbatch per
      pass;
    * ``mesh``: ``None`` (one device) or a ``torch.distributed``
      DeviceMesh over ``("pod",) "data", "model"`` with a model axis of 1.
      Each rank passes its shard of the global batch (for example
      ``SyntheticLM.batch_at(step, shard, n_shards)``); the gradients are
      summed in float32 over the batch group and divided by its size
      before the clip.  They cross the host in slabs of at most
      ``optim.adamw.SLAB`` elements (gloo ships host tensors);
      ``comm_bytes`` and ``comm_seconds`` count that traffic.  The
      reference's ``zero1`` only places the moments, which the port keeps
      replicated, so the port has no such field.
    """
    cfg: ModelConfig
    mesh: Optional[object] = None
    microbatch: int = 0          # 0 = auto
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    clip_norm: float = 1.0
    comm_bytes: int = dataclasses.field(default=0, init=False)
    comm_seconds: float = dataclasses.field(default=0.0, init=False)

    def __post_init__(self):
        sizes = mesh_sizes(self.mesh)
        if sizes.get(MODEL_AXIS, 1) > 1:
            raise _sharding(f"a train step over a model axis of "
                            f"{sizes[MODEL_AXIS]} (tensor parallelism)")
        self.n_data = _axis_size(sizes, batch_axes(self.mesh))
        self._group = _batch_group(self.mesh) if self.n_data > 1 else None

    def auto_microbatch(self, shape: ShapeSpec) -> int:
        """Pick accumulation so activations fit: target <= ~2 GiB of
        layer-input remat buffers per device."""
        if self.microbatch:
            return self.microbatch
        b_dev = max(1, shape.global_batch // self.n_data)
        cfg = self.cfg
        bytes_per_b = shape.seq_len * cfg.d_model * 2 * cfg.n_layers
        budget = 2 * 2 ** 30
        micro = 1
        while b_dev // micro > 1 and (b_dev // micro) * bytes_per_b > budget:
            micro *= 2
        return min(micro, b_dev)

    @torch.no_grad()
    def _average(self, tensors: list) -> None:
        """Replace each tensor by its mean over the batch group, in place:
        slab by slab through the host, summed in float32."""
        t0 = time.perf_counter()
        for t in tensors:
            for (ts,) in _slabs(t):
                buf = ts.to("cpu", torch.float32)
                dist.all_reduce(buf, group=self._group)
                ts.copy_(buf.div_(self.n_data))
                self.comm_bytes += 4 * buf.numel()
        self.comm_seconds += time.perf_counter() - t0

    def grads_fn(self, shape: Optional[ShapeSpec] = None):
        """``grads(params, batch) -> (loss, metrics, grads)`` of this
        rank's batch: accumulated over the microbatches, averaged over the
        batch group, not yet clipped."""
        cfg = self.cfg
        micro = self.auto_microbatch(shape) if shape is not None else 1
        if cfg.cost_mode:
            micro = 1      # cost compiles measure one full-batch pass

        def grads_of(params, batch):
            # aliases that record autograd, so the caller's tensors stay
            # plain (the update writes them in place); a leaf the loss does
            # not read (the audio frontend's embed) gets zeros, as under
            # the reference's jax.grad
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, metrics = M.loss_fn(cfg, live, batch)
            grads = iter(torch.autograd.grad(loss, tree_leaves(live),
                                             materialize_grads=True))
            return loss.detach(), metrics, tree_map(lambda _: next(grads),
                                                    params)

        def run(params, batch):
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
            if self._group is not None:
                names = sorted(metrics)
                scalars = torch.stack([loss.float()] + [
                    metrics[k].float() for k in names])
                self._average(tree_leaves(grads) + [scalars])
                loss = scalars[0]
                metrics = dict(zip(names, scalars[1:]))
            return loss, metrics, grads

        return run

    def step_fn(self, shape: Optional[ShapeSpec] = None):
        grads_of = self.grads_fn(shape)

        def step(params, opt_state, batch):
            loss, metrics, grads = grads_of(params, batch)
            grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
            lr = cosine_schedule(opt_state.step, peak_lr=self.peak_lr,
                                 warmup=self.warmup, total=self.total_steps)
            params, opt_state = adamw_update(params, grads, opt_state, lr=lr)
            metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
            return params, opt_state, metrics

        return step


class ServeStep:
    """Not ported: the sharded decode step (queue 1 item 8, step 3)."""

    def __init__(self, *args, **kwargs):
        raise _sharding("ServeStep (the sharded decode step)")


def make_prefill_fn(cfg: ModelConfig, mesh):
    raise _sharding("make_prefill_fn (the sharded prefill)")
