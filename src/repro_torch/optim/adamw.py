"""AdamW in plain PyTorch (the port of ``repro/optim/adamw.py``).

* moments are kept in float32 regardless of the parameters' type;
* the reference's arithmetic: bias-corrected moments, decoupled weight
  decay, global-norm clipping and a cosine schedule with linear warmup;
* unlike the reference, which is pure, :func:`adamw_update` and
  :func:`clip_by_global_norm` update their tensors in place, one leaf at
  a time and one slab of at most :data:`SLAB` elements at a time, so the
  float32 temporaries of a full model (its largest leaf, the stacked
  ``w_gate`` of ``h2o-danube3-4b``, is 24 x 3840 x 10240) never live at
  once.  The functions still return what the reference returns;
* on a sharded step (``launch/sharding.py``) the clip sums the squares
  of a rank's blocks over the mesh, and the update works on a rank's
  ZeRO-1 slices of the gradients and moments and all-gathers the
  parameters back.

Trees are nested dicts of tensors; leaves are walked in the reference's
pytree order (sorted keys).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

#: elements of a leaf that one in-place step works on at a time
SLAB = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: dict                  # float32 tree like params
    v: dict                  # float32 tree like params


def tree_leaves(tree) -> list:
    """The tensors of a nested dict in the reference's order (sorted
    keys)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn, tree):
    """``fn`` of every leaf, called in :func:`tree_leaves`'s order."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key]) for key in sorted(tree)}
    return fn(tree)


def _slabs(*tensors):
    """Matching views of at most :data:`SLAB` elements of contiguous
    tensors of one shape (in-place work on a view updates the tensor)."""
    flat = [t.view(-1) for t in tensors]
    return zip(*(f.split(SLAB) for f in flat))


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, *, groups=(), counts=None,
                        stats=None):
    """Scale ``grads`` in place so that their global norm is at most
    ``max_norm``; returns ``(grads, norm before clipping)``, the norm a
    float32 tensor.

    Sharded, ``grads`` are this rank's blocks and ``counts`` a matching
    tree of how many ranks hold each block alike: each rank adds
    1 / count of a block's squares, and the sum is all-reduced over each
    of ``groups`` in turn (the model group, then the batch group), so
    every leaf counts once."""
    leaves = tree_leaves(grads)
    cnts = tree_leaves(counts) if counts is not None else [1] * len(leaves)
    sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g, n in zip(leaves, cnts):
        acc = torch.zeros_like(sq)
        for (gs,) in _slabs(g):
            acc += gs.to(torch.float32, copy=True).square_().sum()
        sq += acc / n
    if groups:
        from repro_torch.core.distributed import all_reduce
        for group in groups:
            sq = all_reduce(group, sq, stats)
    gn = sq.sqrt()
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for g in leaves:
        for (gs,) in _slabs(g):
            gs.copy_(gs.float() * scale)
    return grads, gn


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, shards=None, group=None,
                 stats=None):
    """Returns (params, state), both updated in place.  ``lr`` may be a
    scalar or a schedule value computed from ``state.step`` by the
    caller.

    ZeRO-1: ``shards`` (a tree matching ``params``) gives each leaf whose
    moments are a slice of the parameter as ``(dim, part, parts)``, the
    part-th of ``parts`` equal slices along ``dim``, or None.  Such a
    leaf's gradient is that slice (a reduce-scatter's part); the slice
    of the parameter is updated and the parameter is then all-gathered
    along ``dim`` over ``group`` (the ranks holding the other slices, in
    part order), so it stays equal on all of them."""
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    ps = tree_leaves(params)
    sh = tree_leaves(shards) if shards is not None else [None] * len(ps)
    for p, g, m, v, cut in zip(ps, tree_leaves(grads), tree_leaves(state.m),
                               tree_leaves(state.v), sh):
        if cut is not None:
            dim, part, parts = cut
            n = p.shape[dim] // parts
            whole, p = p, p.narrow(dim, part * n, n).contiguous()
        for pv, gs, ms, vs in _slabs(p, g, m, v):
            gf = gs.float()
            ms.mul_(b1).add_(gf * (1.0 - b1))
            vs.mul_(b2).add_(gf.square() * (1.0 - b2))
            delta = (ms / c1).div_((vs / c2).sqrt_().add_(eps))
            pf = pv.float()
            delta.add_(weight_decay * pf)
            pv.copy_(pf - lr * delta)
        if cut is not None:
            from repro_torch.core.distributed import all_gather_along
            whole.copy_(all_gather_along(group, p, dim, stats))
    return params, AdamWState(step=step, m=state.m, v=state.v)


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup then cosine decay to floor * peak_lr (float32)."""
    t = torch.as_tensor(step).float()
    warm = peak_lr * t / max(warmup, 1)
    frac = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * \
        (1.0 + torch.cos(math.pi * frac))
    return torch.where(t < warmup, warm, cos)
