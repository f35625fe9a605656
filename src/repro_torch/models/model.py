"""The LM of the assigned architectures, attention family (the port of
``repro/models/model.py``).

One parameter schema + three entry points:

* ``forward``      — full-sequence logits (training and prefill); under
  autograd with ``remat=True`` each layer is recomputed in the backward
  pass (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``);
* ``loss_fn``      — next-token cross-entropy for training;
* ``decode_step``  — one token with a KV cache (serve path).

Parameters are a nested dict of tensors with the reference's keys and
layouts; the layers are stacked along a leading L axis and run in a
Python loop.  :func:`params_from_numpy` and :func:`adamw_state_from_numpy`
carry the reference's parameters and optimizer state across.  The dense
family runs and trains; the MoE FFN, the Mamba mixers of the ssm and
hybrid families and the frame / patch frontends raise
``NotImplementedError`` naming ROADMAP.md queue 1 item 8.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.optim import AdamWState

from . import layers as L
from .config import ModelConfig

Params = dict


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1 item 8: LM "
        f"substrate)")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "hybrid" or cfg.mixer != "attention":
        raise _not_ported(f"the {cfg.mixer} mixer ({cfg.family} family)")
    if cfg.n_experts:
        raise _not_ported("the MoE FFN")
    if cfg.frontend != "tokens":
        raise _not_ported(f"the {cfg.frontend} frontend")


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _attn_param_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": lead + (d, cfg.n_heads * hd),
        "wk": lead + (d, cfg.n_kv_heads * hd),
        "wv": lead + (d, cfg.n_kv_heads * hd),
        "wo": lead + (cfg.n_heads * hd, d),
    }


def _mlp_param_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"w_gate": lead + (d, ff), "w_up": lead + (d, ff),
                "w_down": lead + (ff, d)}
    return {"w1": lead + (d, ff), "w2": lead + (ff, d)}


def param_shapes(cfg: ModelConfig) -> dict:
    """Nested dict of parameter shapes (schema single source of truth)."""
    _check_family(cfg)
    d, lead = cfg.d_model, (cfg.n_layers,)
    shapes: dict = {"embed": (cfg.vocab, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.vocab, d)
    shapes["layers"] = {**_attn_param_shapes(cfg, lead),
                        "norm_attn": lead + (d,), "norm_mlp": lead + (d,),
                        **_mlp_param_shapes(cfg, lead)}
    return shapes


def _leaves(tree: dict, path=()):
    """(path, leaf) in the reference's pytree order: sorted keys."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], path + (key,))
        else:
            yield path + (key,), tree[key]


def _unflatten(items) -> dict:
    out: dict = {}
    for path, leaf in items:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Random parameters with the reference's distributions: norms zero
    (float32), every other weight normal * fan_in**-0.5 in the config's
    type, fan_in being the second-to-last axis.  The parameters lie on
    ``device`` (the card unless it is ``"cpu"``); the draws come from
    ``generator``, which must be on the same kind of device (seed 0 when
    not given), so they are not the reference's: carry its weights across
    with :func:`params_from_numpy`.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    elif generator.device.type != device.type:
        raise ValueError(f"init_params: generator on {generator.device}, "
                         f"parameters asked for on {device}")
    out = []
    for path, shape in _leaves(param_shapes(cfg)):
        if "norm" in path[-1]:
            out.append((path, torch.zeros(shape, device=device)))
            continue
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        w = torch.randn(shape, generator=generator, device=device)
        out.append((path, w.mul_(fan_in ** -0.5).to(cfg.torch_dtype)))
    return _unflatten(out)


def params_from_numpy(tree: dict, device=None) -> Params:
    """The reference's parameter tree as numpy arrays (``np.asarray`` of
    each JAX leaf) -> the port's, same nested keys, layers stacked on the
    leading axis as they are.  bfloat16 arrays cross as their bits."""
    device = resolve_device(device)
    return _unflatten((path, _from_numpy(a, device))
                      for path, a in _leaves(tree))


def _from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)                  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def adamw_state_from_numpy(step, m: dict, v: dict, device=None):
    """The reference's ``AdamWState`` as numpy (``step`` and the moment
    trees, each leaf ``np.asarray`` of the JAX leaf) -> the port's
    :class:`repro_torch.optim.AdamWState` on ``device``."""
    device = resolve_device(device)
    return AdamWState(step=_from_numpy(np.asarray(step, np.int32), device),
                      m=params_from_numpy(m, device),
                      v=params_from_numpy(v, device))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
         positions: torch.Tensor):
    """Rotated q (B, S, KV, G, hd) and k, and v (B, S, KV, hd)."""
    b, s, _ = x.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    g = cfg.n_heads // kv
    q = (x @ p["wq"]).reshape(b, s, kv * g, hd)
    k = (x @ p["wk"]).reshape(b, s, kv, hd)
    v = (x @ p["wv"]).reshape(b, s, kv, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta).reshape(b, s, kv, g, hd)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    if cfg.swa_window and cfg.swa_window < s:
        out = L.windowed_attention(q, k, v, window=cfg.swa_window,
                                   causal=cfg.causal,
                                   block=min(1024, s, cfg.swa_window))
    else:
        qc = min(4096 if cfg.cost_mode else 512, s)
        kc = min(8192 if cfg.cost_mode else 1024, s)
        out = L.chunked_attention(q, k, v, causal=cfg.causal,
                                  q_chunk=qc, kv_chunk=kc,
                                  unroll=cfg.cost_mode)
    return out.reshape(b, s, -1) @ p["wo"]


def _mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        return L.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    return L.gelu_mlp(x, p["w1"], p["w2"])


def _attn_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm attention + FFN block. Returns (x, aux_loss)."""
    h = L.apply_norm(cfg.norm, x, p.get("norm_attn"))
    x = x + _attention(cfg, p, h, positions)
    h = L.apply_norm(cfg.norm, x, p.get("norm_mlp"))
    x = x + _mlp(cfg, p, h)
    return x, torch.zeros((), device=x.device)


def _layer(params: Params, i: int) -> dict:
    return {k: w[i] for k, w in params["layers"].items()}


def _unembed(cfg: ModelConfig, params: Params, x: torch.Tensor):
    x = L.apply_norm(cfg.norm, x, params.get("final_norm"))
    unembed = params.get("unembed", params["embed"])
    return x @ unembed.T.to(x.dtype)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: Params, batch: dict,
            remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits. Returns (logits (B,S,V), aux_loss).

    ``batch["tokens"]``: (B, S) integer token ids.  With ``remat`` and
    gradients on, each layer keeps only its input for the backward pass and
    is run again there (``torch.utils.checkpoint``, non-reentrant), as the
    reference's ``jax.checkpoint`` around each layer body: on the window
    path the attention kernel then launches twice a layer and step.
    Without gradients (``torch.inference_mode()``, the prefill) ``remat``
    changes nothing.
    """
    _check_family(cfg)
    embed = params["embed"]
    tokens = torch.as_tensor(batch["tokens"], device=embed.device).long()
    x = embed[tokens].to(cfg.torch_dtype)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), device=x.device)
    # one unbind per stacked leaf: its backward stacks the layers'
    # gradients once, where indexing would add a full-size zero-filled
    # gradient per layer
    stacks = {k: w.unbind(0) for k, w in params["layers"].items()}
    recompute = remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = {k: ws[i] for k, ws in stacks.items()}
        if recompute:
            x, a = checkpoint(_attn_block, cfg, lp, x, positions,
                              use_reentrant=False)
        else:
            x, a = _attn_block(cfg, lp, x, positions)
        aux = aux + a
    return _unembed(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params: Params, batch: dict,
            remat: bool = True) -> tuple[torch.Tensor, dict]:
    """Mean next-token negative log-likelihood (+ 0.01 aux).  Returns
    (loss, {"nll", "aux"}); ``batch["targets"]``: (B, S) token ids."""
    logits, aux = forward(cfg, params, batch, remat=remat)
    targets = torch.as_tensor(batch["targets"], device=logits.device).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    loss = nll.mean() + 0.01 * aux
    return loss, {"nll": nll.mean(), "aux": aux}


# ---------------------------------------------------------------------------
# Decode (serve path)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """KV cache (L, B, max_len, KV, hd) in the config's type.

    SWA archs keep the full length too, as the reference's code does (its
    comment speaks of a ring buffer of ``window`` entries; the code keeps
    ``max_len``)."""
    _check_family(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def _decode_attention_layer(cfg: ModelConfig, p: dict, x: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            pos: int) -> torch.Tensor:
    """x: (B, 1, d); caches (B, T, KV, hd), written at ``pos`` in place."""
    b = x.shape[0]
    posb = torch.full((b, 1), pos, device=x.device)
    q, k, v = _qkv(cfg, p, x, posb)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    out = L.decode_attention(q, k_cache, v_cache, pos,
                             window=cfg.swa_window)
    return out.reshape(b, 1, -1) @ p["wo"]


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                cache: dict, pos: int) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: (B,) integer; pos: current length.

    Returns (logits (B, V) float32, cache).  Unlike the reference, which
    returns a new cache, the port writes the new position into ``cache``
    in place and returns it.
    """
    _check_family(cfg)
    embed = params["embed"]
    token = torch.as_tensor(token, device=embed.device).long()
    pos = int(pos)
    x = embed[token][:, None, :].to(cfg.torch_dtype)          # (B, 1, d)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        h = L.apply_norm(cfg.norm, x, p.get("norm_attn"))
        x = x + _decode_attention_layer(cfg, p, h, cache["k"][i],
                                        cache["v"][i], pos)
        h = L.apply_norm(cfg.norm, x, p.get("norm_mlp"))
        x = x + _mlp(cfg, p, h)
    return _unembed(cfg, params, x)[:, 0].float(), cache
