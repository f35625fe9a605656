"""Sharding rules and the train and serve step builders (the port of
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

The reference compiles one SPMD program and lets GSPMD place it.  The
port runs one process a rank: each holds the block of every leaf that the
spec tables assign to its mesh coordinates (:func:`take_block`, the
layout GSPMD uses), and the layers compute on their natural slices with
explicit collectives (:class:`TensorParallel`, ``models/``).  A leaf whose
stored block is not the slice a layer computes with is all-gathered over
the model group before use, and named and counted.

``TrainStep`` builds the reference's step: gradients of ``model.loss_fn``
(accumulated over microbatches when ``auto_microbatch`` asks for them),
``clip_by_global_norm``, ``cosine_schedule`` at the optimizer's step and
``adamw_update``, in that order.  ``ServeStep`` runs ``decode_step`` on a
rank's parameter and cache blocks, ``make_prefill_fn`` the forward.
Unlike the reference's pure, jit-compiled steps, the port's update the
parameters, the optimizer state and the cache in place (one leaf at a
time, see :mod:`repro_torch.optim.adamw`) and return them.
``abstract_inputs`` gives the dry run (``launch/dryrun.py``) a rank's
inputs as ``meta`` tensors of its blocks.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import distributed as cdist
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeSpec, input_specs
from repro_torch.optim import AdamWState, adamw_init, adamw_update, \
    clip_by_global_norm, cosine_schedule
from repro_torch.optim.adamw import _slabs, tree_leaves, tree_map

MODEL_AXIS = "model"


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
# a rank's blocks under the spec tables
# ---------------------------------------------------------------------------

def mesh_coords(mesh) -> dict:
    """This rank's ``{axis: coordinate}`` on a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _entry_index(entry, sizes: dict, coords: dict) -> int:
    """A rank's part along a dim sharded by ``entry`` (its axes major to
    minor, as GSPMD flattens them)."""
    i = 0
    for a in _entry_axes(entry):
        i = i * sizes[a] + coords[a]
    return i


def block_slices(shape: tuple, spec: tuple, mesh, coords=None) -> tuple:
    """``(start, length)`` per dim of the block that the rank at ``coords``
    (default: this rank's on a DeviceMesh) holds of a leaf of ``shape``
    under ``spec``: each sharded dim cut into equal contiguous parts."""
    sizes = mesh_sizes(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    out = []
    for n, entry in zip(shape, spec):
        size = n // _axis_size(sizes, entry)
        out.append((_entry_index(entry, sizes, coords) * size, size))
    return tuple(out)


def take_block(x: torch.Tensor, spec: tuple, mesh, coords=None
               ) -> torch.Tensor:
    """The block of the whole leaf ``x`` that the rank at ``coords`` holds
    under ``spec`` (a view)."""
    for dim, (start, size) in enumerate(block_slices(x.shape, spec, mesh,
                                                     coords)):
        if size != x.shape[dim]:
            x = x.narrow(dim, start, size)
    return x


def tree_blocks(tree: dict, specs: dict, mesh, coords=None) -> dict:
    """:func:`take_block` of every leaf of a tree of whole leaves."""
    return {k: tree_blocks(v, specs[k], mesh, coords) if isinstance(v, dict)
            else take_block(v, specs[k], mesh, coords)
            for k, v in tree.items()}


_GROUPS: dict = {}


def axes_group(mesh, axes: tuple):
    """The process group of ``mesh`` over ``axes`` that holds this rank,
    its ranks in the order of the axes' flattened coordinate.  Several
    axes make one subgroup per coordinate of the others, built once per
    mesh by every rank in the same order."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), tuple(axes))
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        idx = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in idx]
        n = math.prod(mesh.mesh.shape[i] for i in idx)
        ranks = mesh.mesh.permute(*rest, *idx).reshape(-1, n).tolist()
        _GROUPS[key] = (mesh, dist.new_subgroups_by_enumeration(ranks)[0])
    return _GROUPS[key][1]


def release_groups(mesh) -> None:
    """Forget the subgroups :func:`axes_group` built on ``mesh`` (before its
    world is destroyed)."""
    for key in [k for k in _GROUPS if k[0] == id(mesh)]:
        del _GROUPS[key]


def gather_block(x: torch.Tensor, spec: tuple, mesh,
                 stats: Optional[cdist.CommStats] = None) -> torch.Tensor:
    """The whole leaf from this rank's block ``x`` under ``spec`` on
    ``mesh``: an all-gather along each sharded dim over its axes."""
    sizes = mesh_sizes(mesh)
    for dim, entry in enumerate(spec):
        if _axis_size(sizes, entry) > 1:
            x = cdist.all_gather_along(axes_group(mesh, _entry_axes(entry)),
                                       x, dim, stats)
    return x


# ---------------------------------------------------------------------------
# tensor parallelism: the model axis as the layers see it
# ---------------------------------------------------------------------------

class _Scope:
    """The per-layer specs of one part of the parameter tree (the top
    level, the layer stack, the hybrid's shared block), for
    :meth:`TensorParallel.take`; every other attribute is the group's."""

    def __init__(self, tp: "TensorParallel", specs: dict):
        self.tp, self.specs = tp, specs

    def take(self, p: dict, name: str, dim: int, ranges) -> torch.Tensor:
        return self.tp.take(p[name], self.specs[name], dim, ranges, name)

    def __getattr__(self, name):
        return getattr(self.tp, name)


class TensorParallel(cdist.ModelGroup):
    """The model axis of a DeviceMesh for the LM's layers (``models/``).

    A rank stores every leaf as the block ``param_shardings`` assigns it;
    a layer computes on its natural slice (whole heads, an ff slice,
    experts, vocab rows, mamba channels) and asks :meth:`take` for it:
    the stored block itself when it is that slice, else the leaf
    all-gathered over the model group (named and counted in
    ``stats.gathered``) and cut.  ``top``, ``layers`` and ``shared`` are
    the tree's scopes; ``batch_group`` is the group over the batch axes
    (None when they hold one rank) and ``batch_index`` this rank's place in
    it.  ``cache`` holds ``ServeStep``'s cache specs for a batch of
    ``cache_batch`` rows."""

    def __init__(self, cfg: ModelConfig, mesh, stats=None, cache=None,
                 cache_batch: int = 0):
        super().__init__(mesh.get_group(MODEL_AXIS), stats)
        sizes = mesh_sizes(mesh)
        self.cfg, self.mesh = cfg, mesh
        self.coords = mesh_coords(mesh)
        axes = batch_axes(mesh)
        self.n_batch = _axis_size(sizes, axes)
        self.batch_group = axes_group(mesh, axes) if self.n_batch > 1 \
            else None
        self.batch_index = _entry_index(axes, sizes, self.coords)
        self.cache, self.cache_batch = cache, cache_batch
        specs = param_shardings(cfg, mesh)
        depth = 2 if cfg.family == "hybrid" else 1
        stacked = [k for k, spec in specs["layers"].items()
                   if MODEL_AXIS in spec[:depth]]
        if stacked:
            raise ValueError(f"{cfg.name} on {sizes}: the model axis shards "
                             f"the layer stack of {stacked}; the layers "
                             f"compute on one layer's slices")
        self.top = _Scope(self, {k: v for k, v in specs.items()
                                 if not isinstance(v, dict)})
        self.layers = _Scope(self, {k: spec[depth:] for k, spec in
                                    specs["layers"].items()})
        self.shared = _Scope(self, specs.get("shared", {}))

    def gather_leaf(self, w: torch.Tensor, dim: int, name: str
                    ) -> torch.Tensor:
        """A model-sharded leaf whole, counted under ``name``."""
        w = self.gather(w, dim)
        self.stats.gathered[name] = self.stats.gathered.get(name, 0) + \
            w.numel() * w.element_size()
        return w

    def take(self, w: torch.Tensor, spec, dim: int, ranges, name: str
             ) -> torch.Tensor:
        """The slice ``ranges`` (``(start, stop)`` pairs along ``dim``,
        concatenated) of the leaf this rank stores as ``w`` under
        ``spec``.  A gathered leaf's gradient is reduce-scattered back; a
        replicated one enters the rank-partitioned work."""
        mdims = [i for i, e in enumerate(spec) if e == MODEL_AXIS]
        n = w.shape[dim]
        if mdims == [dim] and list(ranges) == [(self.rank * n,
                                                (self.rank + 1) * n)]:
            return w
        w = self.gather_leaf(w, mdims[0], name) if mdims else self.enter(w)
        parts = [w.narrow(dim, a, b - a) for a, b in ranges]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def tensor_parallel(cfg: ModelConfig, mesh, stats=None
                    ) -> Optional[TensorParallel]:
    """The layers' model group on ``mesh``, or None where the model axis
    holds one rank (the one-device code runs)."""
    if mesh_sizes(mesh).get(MODEL_AXIS, 1) == 1:
        return None
    return TensorParallel(cfg, mesh, stats)


def block_shape(shape: tuple, spec: tuple, mesh, coords=None) -> tuple:
    """The shape of the block of a leaf of ``shape`` under ``spec`` (padded
    with unsharded dims) that the rank at ``coords`` holds."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n for _, n in block_slices(shape, spec, mesh, coords))


def _coords(mesh, coords):
    """``coords`` as given, else this rank's on a DeviceMesh, else the
    origin of a ``{axis: size}`` mesh."""
    if coords is not None:
        return coords
    if isinstance(mesh, Mapping):
        return {a: 0 for a in mesh}
    return mesh_coords(mesh)


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_params(cfg: ModelConfig, specs: dict, mesh, coords,
                 dtype: Optional[torch.dtype] = None) -> dict:
    """Meta blocks of every parameter leaf under ``specs`` (a tree like the
    params), in the leaf's type or ``dtype``."""
    def leaf(path, shape):
        return _meta(block_shape(shape, _at(specs, path), mesh, coords),
                     dtype or M.param_dtype(cfg, path[-1]))
    return _spec_tree(M.param_shapes(cfg), leaf)


def _at(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainStep:
    """Step builder for one (cfg, mesh) pair.

    * ``microbatch``: gradient-accumulation factor (a loop over
      microbatches) — bounds activation memory at B_device/microbatch per
      pass;
    * ``mesh``: ``None`` (one device), a ``torch.distributed`` DeviceMesh
      over ``("pod",) "data", "model"``, or for the spec methods alone a
      ``{axis: size}`` dict.  Each rank holds the block of every parameter
      that ``param_shardings`` assigns it and passes its shard of the
      global batch (for example ``SyntheticLM.batch_at(step, shard,
      n_shards)`` over the batch axes).  A model axis larger than 1 runs
      the layers tensor-parallel (:class:`TensorParallel`); the gradients
      are summed in float32 over the batch group and divided by its size
      before the clip, crossing the host in slabs of at most
      ``optim.adamw.SLAB`` elements (gloo ships host tensors);
    * ``zero1`` (the reference's default): the moments are the blocks of
      ``zero1_shardings``; the gradients are reduce-scattered to each
      rank's slice, each rank updates its moment slice and that slice of
      its parameters, then the parameters are all-gathered over the batch
      axes (:meth:`adamw_init` makes the moments).
      ``comm_bytes`` and ``comm_seconds`` count every collective.
    """
    cfg: ModelConfig
    mesh: Optional[object] = None
    zero1: bool = True
    microbatch: int = 0          # 0 = auto
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    clip_norm: float = 1.0
    stats: cdist.CommStats = dataclasses.field(
        default_factory=cdist.CommStats, init=False)

    def __post_init__(self):
        sizes = mesh_sizes(self.mesh)
        self.n_data = _axis_size(sizes, batch_axes(self.mesh))
        self.n_model = sizes.get(MODEL_AXIS, 1)
        self._built = False

    @property
    def comm_bytes(self) -> int:
        return self.stats.bytes

    @comm_bytes.setter
    def comm_bytes(self, v: int) -> None:
        self.stats.bytes = v

    @property
    def comm_seconds(self) -> float:
        return self.stats.seconds

    @comm_seconds.setter
    def comm_seconds(self, v: float) -> None:
        self.stats.seconds = v

    def _build(self) -> None:
        """The process groups (a DeviceMesh's), made at the first step."""
        if self._built:
            return
        self._built = True
        self._group = axes_group(self.mesh, batch_axes(self.mesh)) \
            if self.n_data > 1 else None
        self.tp = tensor_parallel(self.cfg, self.mesh, self.stats)
        self._shards = self._zero1_shards()
        self._clip_groups, self._clip_counts = self._clip_plan()

    def _clip_plan(self) -> tuple:
        """The groups the clip's sum of squares is all-reduced over (the
        model group, then the batch group under ZeRO-1) and, per leaf,
        how many ranks of them hold its gradient block alike."""
        axes, groups = [], []
        if self.tp is not None:
            axes, groups = [MODEL_AXIS], [self.tp.group]
        if self._shards is not None:
            axes += list(batch_axes(self.mesh))
            groups.append(self._group)
        if not groups:
            return (), None
        sizes = mesh_sizes(self.mesh)
        specs = zero1_shardings(self.cfg, self.mesh, batch_axes(self.mesh)) \
            if self._shards is not None else self.param_shardings()

        def count(spec):
            held = {a for e in spec for a in _entry_axes(e)}
            return math.prod(sizes[a] for a in axes if a not in held)
        return tuple(groups), tree_map_specs(specs, count)

    def param_shardings(self) -> dict:
        return param_shardings(self.cfg, self.mesh)

    def opt_shardings(self) -> AdamWState:
        ps = self.param_shardings()
        moments = zero1_shardings(self.cfg, self.mesh,
                                  batch_axes(self.mesh)) if self.zero1 \
            else ps
        return AdamWState(step=(), m=moments, v=tree_map_specs(
            moments, lambda s: s))

    def batch_shardings(self, shape: ShapeSpec) -> dict:
        ax = batch_axes(self.mesh)
        return input_specs(self.cfg, shape,
                           batch_spec=(ax if len(ax) > 1 else ax[0],))

    def abstract_inputs(self, shape: ShapeSpec, coords=None):
        """``(params, opt_state, batch)`` of the rank at ``coords`` (this
        rank's on a DeviceMesh, the origin of a ``{axis: size}`` mesh) as
        meta tensors of its blocks: the parameters in their types, the
        moments float32 blocks of :meth:`opt_shardings`, ``step`` a 0-d
        int32, the batch blocks of :meth:`batch_shardings`."""
        cfg, mesh = self.cfg, self.mesh
        coords = _coords(mesh, coords)
        params = _meta_params(cfg, self.param_shardings(), mesh, coords)
        os_specs = self.opt_shardings()
        opt = AdamWState(
            step=_meta((), torch.int32),
            m=_meta_params(cfg, os_specs.m, mesh, coords, torch.float32),
            v=_meta_params(cfg, os_specs.v, mesh, coords, torch.float32))
        batch = {k: _meta(block_shape(s.shape, s.spec, mesh, coords),
                          s.dtype)
                 for k, s in self.batch_shardings(shape).items()}
        return params, opt, batch

    def _zero1_shards(self):
        """Per leaf ``(dim, part, parts)`` of this rank's ZeRO-1 moment
        slice inside its parameter block, or None (moments as the
        parameter block)."""
        if not (self.zero1 and self.n_data > 1):
            return None
        ps = self.param_shardings()
        zs = zero1_shardings(self.cfg, self.mesh, batch_axes(self.mesh))
        part = dist.get_rank(self._group)

        def shard(p, z):
            dims = [i for i, (a, b) in enumerate(zip(p, z)) if a != b]
            return (dims[0], part, self.n_data) if dims else None
        return tree_map_specs(ps, shard, zs)

    def adamw_init(self, params: dict) -> AdamWState:
        """Zero moments of this rank's blocks (its ZeRO-1 slices) of
        ``params`` (this rank's parameter blocks)."""
        self._build()
        state = adamw_init(params)
        if self._shards is None:
            return state

        def cut(m, sh):
            return m if sh is None else m.narrow(
                sh[0], sh[1] * (m.shape[sh[0]] // sh[2]),
                m.shape[sh[0]] // sh[2]).contiguous()
        m = tree_map_specs(state.m, cut, self._shards)
        return AdamWState(step=state.step, m=m,
                          v=tree_map(torch.zeros_like, m))

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
        for t in tensors:
            for (ts,) in _slabs(t):
                ts.copy_(cdist.all_reduce(self._group, ts.float(),
                                          self.stats).div_(self.n_data))

    @torch.no_grad()
    def _mean(self, loss, metrics: dict, grads: dict, scatter: bool):
        """The loss, metrics and gradients averaged over the batch group.
        With ``scatter`` under ZeRO-1 a leaf with a moment slice gets only
        that slice of the mean (a reduce-scatter summed in float32), the
        rest an all-reduce: a step moves the bytes of one all-reduce of
        the gradients."""
        if self._group is None:
            return loss, metrics, grads
        names = sorted(metrics)
        scalars = torch.stack([loss.float()] + [metrics[k].float()
                                                for k in names])
        self._average([scalars])
        metrics = dict(zip(names, scalars[1:]))
        cuts = tree_leaves(self._shards) if scatter and \
            self._shards is not None else [None] * len(tree_leaves(grads))
        out = []
        for g, cut in zip(tree_leaves(grads), cuts):
            if cut is None:
                self._average([g])
                out.append(g)
            else:
                out.append(cdist.reduce_scatter_along(
                    self._group, g, cut[0], self.stats, torch.float32)
                    .div_(self.n_data).to(g.dtype))
        parts = iter(out)
        return scalars[0], metrics, tree_map(lambda _: next(parts), grads)

    def _local_grads_fn(self, shape: Optional[ShapeSpec]):
        """``(loss, metrics, grads)`` of this rank's batch and parameter
        blocks, accumulated over the microbatches, not yet averaged."""
        cfg = self.cfg
        micro = self.auto_microbatch(shape) if shape is not None else 1
        if cfg.cost_mode:
            micro = 1      # cost compiles measure one full-batch pass
        self._build()
        tp = self.tp

        def grads_of(params, batch):
            # aliases that record autograd, so the caller's tensors stay
            # plain (the update writes them in place); a leaf the loss does
            # not read (the audio frontend's embed) gets zeros, as under
            # the reference's jax.grad
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, metrics = M.loss_fn(cfg, live, batch, tp=tp)
            grads = iter(torch.autograd.grad(loss, tree_leaves(live),
                                             materialize_grads=True))
            return loss.detach(), metrics, tree_map(lambda _: next(grads),
                                                    params)

        def run(params, batch):
            if micro <= 1:
                loss, metrics, grads = grads_of(params, batch)
                return loss, {k: v.detach() for k, v in metrics.items()}, \
                    grads

            def split(x):
                x = torch.as_tensor(x)
                return x.reshape(micro, x.shape[0] // micro, *x.shape[1:])

            mb = {k: split(v) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(micro):
                li, _, gi = grads_of(params, {k: v[i] for k, v in mb.items()})
                for a, g in zip(tree_leaves(grads), tree_leaves(gi)):
                    a.add_(g.float())
                loss = loss + li
            for g in tree_leaves(grads):
                g.div_(micro)
            return loss / micro, {}, grads

        return run

    def grads_fn(self, shape: Optional[ShapeSpec] = None):
        """``grads(params, batch) -> (loss, metrics, grads)`` of this
        rank's batch and parameter blocks: accumulated over the
        microbatches, averaged over the batch group (whole blocks), not
        yet clipped."""
        local = self._local_grads_fn(shape)

        def run(params, batch):
            return self._mean(*local(params, batch), scatter=False)

        return run

    def step_fn(self, shape: Optional[ShapeSpec] = None):
        local = self._local_grads_fn(shape)

        def step(params, opt_state, batch):
            loss, metrics, grads = self._mean(*local(params, batch),
                                              scatter=True)
            grads, gnorm = clip_by_global_norm(
                grads, self.clip_norm, groups=self._clip_groups,
                counts=self._clip_counts, stats=self.stats)
            lr = cosine_schedule(opt_state.step, peak_lr=self.peak_lr,
                                 warmup=self.warmup, total=self.total_steps)
            params, opt_state = adamw_update(
                params, grads, opt_state, lr=lr, shards=self._shards,
                group=self._group, stats=self.stats)
            metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
            return params, opt_state, metrics

        return step


def tree_map_specs(specs: dict, fn, *others) -> dict:
    """``fn`` of every spec of a spec tree (tuples are leaves), with the
    matching leaves of ``others``."""
    return {k: tree_map_specs(v, fn, *(o[k] for o in others))
            if isinstance(v, dict) else fn(v, *(o[k] for o in others))
            for k, v in specs.items()}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, mesh, batch: int, max_len: int) -> dict:
    """The spec of every cache leaf (``ServeStep.cache_shardings``)."""
    ax = batch_axes(mesh)
    dax = ax if len(ax) > 1 else ax[0]
    seq_sharded = batch == 1        # long_500k: shard the sequence instead

    def spec(name, shape):
        if name in ("k", "v"):
            # (L, B, T, KV, hd); when KV < |model| the fixup moves the
            # model axis onto hd
            if seq_sharded:
                base = [None, None, dax, MODEL_AXIS, None]
            else:
                base = [None, dax, None, MODEL_AXIS, None]
        elif name == "conv":
            base = [None] * (len(shape) - 1) + [MODEL_AXIS]
        elif name == "ssm":
            # (L, B, di, N) mamba1 / (G, K, B, nh, hd, N) mamba2
            base = [None] * len(shape)
            base[2 if cfg.mixer == "mamba1" else 3] = MODEL_AXIS
        else:
            base = [None] * len(shape)
        return tuple(_fix_spec(mesh, shape, base))

    return {k: spec(k, shape) for k, (shape, _) in
            M.cache_shapes(cfg, batch, max_len).items()}


@dataclasses.dataclass
class ServeStep:
    """Decode-step builder (one new token against a KV/SSM cache) on a
    DeviceMesh (a ``{axis: size}`` dict for :meth:`cache_shardings`).

    Each rank holds its parameter blocks and its cache blocks
    (:meth:`init_cache`).  ``step(params, token, cache, pos)`` takes this
    rank's rows of the batch (the whole batch when ``global_batch`` is 1:
    the cache is then sharded along the sequence over the batch axes and
    attention combines its softmax across them) and returns their logits
    (B_rank, V) float32 and the cache, written in place."""
    cfg: ModelConfig
    mesh: object
    shape: ShapeSpec

    def cache_shardings(self) -> dict:
        return cache_specs(self.cfg, self.mesh, self.shape.global_batch,
                           self.shape.seq_len)

    def init_cache(self, device=None) -> dict:
        return M.init_cache(self.cfg, self.shape.global_batch,
                            self.shape.seq_len, device=device,
                            mesh=self.mesh)

    def abstract_inputs(self, coords=None):
        """``(params, token, cache, pos)`` of the rank at ``coords`` (as
        :meth:`TrainStep.abstract_inputs`) as meta tensors: its parameter
        and cache blocks, its rows of the token batch (B_rank,) int32 (the
        whole batch of 1 when the cache is sharded along the sequence), and
        ``pos`` a 0-d int32."""
        cfg, mesh, b = self.cfg, self.mesh, self.shape.global_batch
        coords = _coords(mesh, coords)
        params = _meta_params(cfg, param_shardings(cfg, mesh), mesh, coords)
        specs = self.cache_shardings()
        cache = {k: _meta(block_shape(shp, specs[k], mesh, coords), dt)
                 for k, (shp, dt) in M.cache_shapes(
                     cfg, b, self.shape.seq_len).items()}
        ax = batch_axes(mesh)
        tok_spec = ((ax if len(ax) > 1 else ax[0]),) if b > 1 else (None,)
        token = _meta(block_shape((b,), tok_spec, mesh, coords), torch.int32)
        return params, token, cache, _meta((), torch.int32)

    def step_fn(self):
        cfg, b = self.cfg, self.shape.global_batch
        specs = self.cache_shardings()
        n = _axis_size(mesh_sizes(self.mesh), batch_axes(self.mesh))
        if n > 1 and ((b > 1 and b % n) or "k" in specs and
                      specs["k"][2 if b == 1 else 1] is None):
            raise ValueError(f"ServeStep: a batch of {b} over {n} batch "
                             f"ranks; the port decodes a batch that divides "
                             f"them, or a batch of 1 along the sequence")
        tp = TensorParallel(cfg, self.mesh, cache=specs, cache_batch=b)
        self.tp = tp

        def step(params, token, cache, pos):
            with torch.no_grad():
                return M.decode_step(cfg, params, token, cache, pos, tp=tp)

        return step


def make_prefill_fn(cfg: ModelConfig, mesh=None):
    """Full-sequence forward (inference-prefill shape): ``prefill(params,
    batch)`` of this rank's parameter blocks and batch rows returns their
    logits over the whole vocabulary, as the one-device forward does; its
    ``tp`` attribute is the model group (its ``stats``), None on one
    device."""
    tp = tensor_parallel(cfg, mesh)

    def prefill(params, batch):
        with torch.no_grad():
            logits, _ = M.forward(cfg, params, batch, remat=False, tp=tp)
            return logits if tp is None else tp.gather_uneven(
                logits, -1, cfg.vocab)

    prefill.tp = tp
    return prefill
