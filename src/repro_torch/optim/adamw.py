"""AdamW in plain PyTorch (the port of ``repro/optim/adamw.py``).

* moments are kept in float32 regardless of the parameters' type;
* the reference's arithmetic: bias-corrected moments, decoupled weight
  decay, global-norm clipping and a cosine schedule with linear warmup;
* unlike the reference, which is pure, :func:`adamw_update` and
  :func:`clip_by_global_norm` update their tensors in place, one leaf at
  a time and one slab of at most :data:`SLAB` elements at a time, so the
  float32 temporaries of a full model (its largest leaf, the stacked
  ``w_gate`` of ``h2o-danube3-4b``, is 24 x 3840 x 10240) never live at
  once.  The functions still return what the reference returns.

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
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place so that their global norm is at most
    ``max_norm``; returns ``(grads, norm before clipping)``, the norm a
    float32 tensor."""
    leaves = tree_leaves(grads)
    sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        for (gs,) in _slabs(g):
            sq += gs.to(torch.float32, copy=True).square_().sum()
    gn = sq.sqrt()
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for g in leaves:
        for (gs,) in _slabs(g):
            gs.copy_(gs.float() * scale)
    return grads, gn


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """Returns (params, state), both updated in place.  ``lr`` may be a
    scalar or a schedule value computed from ``state.step`` by the
    caller."""
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        for ps, gs, ms, vs in _slabs(p, g, m, v):
            gf = gs.float()
            ms.mul_(b1).add_(gf * (1.0 - b1))
            vs.mul_(b2).add_(gf.square() * (1.0 - b2))
            delta = (ms / c1).div_((vs / c2).sqrt_().add_(eps))
            pf = ps.float()
            delta.add_(weight_decay * pf)
            ps.copy_(pf - lr * delta)
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
