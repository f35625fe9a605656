"""The LM of the assigned architectures (the port of
``repro/models/model.py``).

One parameter schema + three entry points:

* ``forward``      — full-sequence logits (training and prefill); under
  autograd with ``remat=True`` each layer is recomputed in the backward
  pass (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``);
* ``loss_fn``      — next-token cross-entropy for training;
* ``decode_step``  — one token with KV / SSM caches (serve path).

Families:
  dense / audio / vlm : attention + (Swi)GLU blocks, uniform stack
  moe                 : attention + MoE FFN (capacity-bounded dispatch)
  ssm (mamba1)        : pure Mamba1 blocks, no attention anywhere
  hybrid (mamba2)     : Mamba2 stack with ONE shared attention+MLP block
                        applied every ``attn_every`` layers (zamba2-style;
                        the shared block has a single parameter set)

Parameters are a nested dict of tensors with the reference's keys and
layouts; the layers are stacked along a leading L axis (``(groups,
attn_every)`` for the hybrid) and run in a Python loop.
:func:`params_from_numpy` and :func:`adamw_state_from_numpy` carry the
reference's parameters and optimizer state across.  The audio and VLM
frontends are the reference's stubs: the batch carries precomputed frame
or patch embeddings (:func:`_embed_inputs`).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.optim import AdamWState

from . import layers as L
from . import ssm
from .config import ModelConfig

Params = dict


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


def _mamba1_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    d, di, st, dr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    return {
        "in_proj": lead + (d, 2 * di),
        "conv": lead + (di, cfg.d_conv),
        "x_proj": lead + (di, dr + 2 * st),
        "dt_proj": lead + (dr, di),
        "dt_bias": lead + (di,),
        "A_log": lead + (di, st),
        "D": lead + (di,),
        "out_proj": lead + (di, d),
    }


def _mamba2_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    d, di, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.n_ssm_heads
    return {
        "in_proj": lead + (d, 2 * di + 2 * st + nh),
        "conv": lead + (di + 2 * st, cfg.d_conv),
        "A_log": lead + (nh,),
        "D": lead + (nh,),
        "dt_bias": lead + (nh,),
        "norm_scale": lead + (di,),
        "out_proj": lead + (di, d),
    }


def param_shapes(cfg: ModelConfig) -> dict:
    """Nested dict of parameter shapes (schema single source of truth)."""
    d = cfg.d_model
    shapes: dict = {"embed": (cfg.vocab, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.vocab, d)
    if cfg.frontend == "patches":
        shapes["patch_proj"] = (d, d)

    if cfg.family == "hybrid":
        lead = (cfg.n_layers // cfg.attn_every, cfg.attn_every)
        shapes["layers"] = {**_mamba2_shapes(cfg, lead),
                            "norm_mixer": lead + (d,)}
        shapes["shared"] = {**_attn_param_shapes(cfg, ()),
                            **_mlp_param_shapes(cfg, ()),
                            "norm_attn": (d,), "norm_mlp": (d,)}
        return shapes

    lead = (cfg.n_layers,)
    if cfg.mixer == "mamba1":
        shapes["layers"] = {**_mamba1_shapes(cfg, lead),
                            "norm_mixer": lead + (d,)}
        return shapes

    layer: dict = {**_attn_param_shapes(cfg, lead),
                   "norm_attn": lead + (d,), "norm_mlp": lead + (d,)}
    if cfg.n_experts:
        layer["router"] = lead + (d, cfg.n_experts)
        layer["w_gate"] = lead + (cfg.n_experts, d, cfg.d_ff)
        layer["w_up"] = lead + (cfg.n_experts, d, cfg.d_ff)
        layer["w_down"] = lead + (cfg.n_experts, cfg.d_ff, d)
    else:
        layer.update(_mlp_param_shapes(cfg, lead))
    shapes["layers"] = layer
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
    """Random parameters with the reference's distributions: norms, ``D``
    and ``A_log`` zero and ``dt_bias`` -2 (float32), every other weight
    normal * fan_in**-0.5 in the config's type, fan_in being the
    second-to-last axis.  The parameters lie on ``device`` (the card unless
    it is ``"cpu"``); the draws come from ``generator``, which must be on
    the same kind of device (seed 0 when not given), so they are not the
    reference's: carry its weights across with :func:`params_from_numpy`.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    elif generator.device.type != device.type:
        raise ValueError(f"init_params: generator on {generator.device}, "
                         f"parameters asked for on {device}")
    out = []
    for path, shape in _leaves(param_shapes(cfg)):
        name = path[-1]
        if "norm" in name or name in ("D", "A_log"):
            # A_log = 0 -> decay rate -1 (stable); norms start at identity
            out.append((path, torch.zeros(shape, device=device)))
        elif name == "dt_bias":
            out.append((path, torch.full(shape, -2.0, device=device)))
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            out.append((path, _normal(shape, fan_in ** -0.5, cfg.torch_dtype,
                                      generator, device)))
    return _unflatten(out)


#: a leaf of more elements is drawn one slice of its leading axis at a time
_DRAW_SLAB = 2 ** 30


def _normal(shape: tuple, scale: float, dtype: torch.dtype,
            generator: torch.Generator, device) -> torch.Tensor:
    """normal * scale in ``dtype``, drawn in float32; a leaf larger than
    ``_DRAW_SLAB`` elements (the experts of a full-width MoE stack) is
    drawn slice by slice, so its float32 draws never live at once."""
    if math.prod(shape) <= _DRAW_SLAB:
        w = torch.randn(shape, generator=generator, device=device)
        return w.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for part in out:
        part.copy_(_normal(shape[1:], scale, dtype, generator, device))
    return out


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
    """Pre-norm attention + FFN/MoE block. Returns (x, aux_loss)."""
    h = L.apply_norm(cfg.norm, x, p.get("norm_attn"))
    x = x + _attention(cfg, p, h, positions)
    h = L.apply_norm(cfg.norm, x, p.get("norm_mlp"))
    if cfg.n_experts:
        y, aux = L.moe_ffn_batched(h, p["router"], p["w_gate"], p["w_up"],
                                   p["w_down"], top_k=cfg.top_k,
                                   capacity_factor=cfg.moe_capacity_factor)
        return x + y, aux
    return x + _mlp(cfg, p, h), torch.zeros((), device=x.device)


def _mamba1_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  chunk: int) -> torch.Tensor:
    h = L.apply_norm(cfg.norm, x, p.get("norm_mixer"))
    return x + ssm.mamba1_forward(p, h, state=cfg.ssm_state, chunk=chunk)


def _mamba2_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  chunk: int) -> torch.Tensor:
    h = L.apply_norm(cfg.norm, x, p.get("norm_mixer"))
    return x + ssm.mamba2_forward(p, h, state=cfg.ssm_state,
                                  head_dim=cfg.ssm_head_dim, chunk=chunk)


def _unstack(w: torch.Tensor, depth: int):
    """The layers of a leaf stacked on ``depth`` leading axes, as nested
    lists of views: one ``unbind`` per axis, whose backward stacks the
    layers' gradients once, where indexing would add a full-size
    zero-filled gradient per layer."""
    if depth == 0:
        return w
    return [_unstack(t, depth - 1) for t in w.unbind(0)]


def _layers(params: Params, depth: int = 1) -> list:
    """Per layer (nested ``depth`` deep) the dict of its parameters."""
    stacks = {k: _unstack(w, depth) for k, w in params["layers"].items()}

    def pick(node: dict, lvl: int):
        n = len(next(iter(node.values())))
        out = [{k: v[i] for k, v in node.items()} for i in range(n)]
        return out if lvl == 1 else [pick(o, lvl - 1) for o in out]
    return pick(stacks, depth)


def _unembed(cfg: ModelConfig, params: Params, x: torch.Tensor):
    x = L.apply_norm(cfg.norm, x, params.get("final_norm"))
    unembed = params.get("unembed", params["embed"])
    return x @ unembed.T.to(x.dtype)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _run(recompute: bool, fn, *args):
    """``fn(*args)``, kept for the backward pass by its input only (run
    again there) when ``recompute``."""
    if recompute:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _embed_inputs(cfg: ModelConfig, params: Params, batch: dict
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,d) in the config's type, positions (B,S)).

    The frontends are the reference's stubs: frames (B, S, d) are the
    input itself; patches (B, n_patches, d) go through ``patch_proj`` and
    come before the embedded text tokens.  Positions run over all of S."""
    embed = params["embed"]
    dev, dtype = embed.device, cfg.torch_dtype

    def field(name):
        return torch.as_tensor(batch[name], device=dev)

    if cfg.frontend == "frames":
        x = field("frames")
    else:
        x = embed[field("tokens").long()]
        if cfg.frontend == "patches":
            pat = field("patches").to(dtype) @ params["patch_proj"]
            x = torch.cat([pat, x], dim=1)
    b, s, _ = x.shape
    return x.to(dtype), torch.arange(s, device=dev).expand(b, s)


def forward(cfg: ModelConfig, params: Params, batch: dict,
            remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits. Returns (logits (B,S,V), aux_loss).

    ``batch``: ``tokens`` (B, S) integer token ids; the audio frontend
    takes ``frames`` (B, S, d) instead, the VLM frontend ``patches`` (B,
    n_patches, d) besides ``tokens`` (B, S - n_patches).  With ``remat``
    and gradients on, each layer keeps only its input for the backward
    pass and is run again there (``torch.utils.checkpoint``,
    non-reentrant), as the reference's ``jax.checkpoint`` around each
    layer body (the hybrid: each group, and each mamba layer inside it):
    on the window path the attention kernel then launches twice a layer
    and step.  Without
    gradients (``torch.inference_mode()``, the prefill) ``remat`` changes
    nothing.
    """
    x, positions = _embed_inputs(cfg, params, batch)
    aux = torch.zeros((), device=x.device)
    recompute = remat and torch.is_grad_enabled()
    if cfg.family == "hybrid":
        x = _hybrid_stack(cfg, params, x, positions, recompute)
    elif cfg.mixer == "mamba1":
        chunk = 1024 if cfg.cost_mode else 256
        for lp in _layers(params):
            x = _run(recompute, _mamba1_block, cfg, lp, x, chunk)
    else:
        for lp in _layers(params):
            x, a = _run(recompute, _attn_block, cfg, lp, x, positions)
            aux = aux + a
    return _unembed(cfg, params, x), aux


def _hybrid_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
                  positions: torch.Tensor, recompute: bool) -> torch.Tensor:
    chunk = 512 if cfg.cost_mode else 128

    def group(gp: list, x: torch.Tensor) -> torch.Tensor:
        for lp in gp:
            x = _run(recompute, _mamba2_block, cfg, lp, x, chunk)
        # shared attention + MLP block (single parameter set, reused)
        return _attn_block(cfg, params["shared"], x, positions)[0]

    for gp in _layers(params, depth=2):
        x = _run(recompute, group, gp, x)
    return x


def loss_fn(cfg: ModelConfig, params: Params, batch: dict,
            remat: bool = True) -> tuple[torch.Tensor, dict]:
    """Mean next-token negative log-likelihood (+ 0.01 aux).  Returns
    (loss, {"nll", "aux"}); ``batch["targets"]``: (B, S) token ids, over
    the text positions only for the VLM frontend."""
    logits, aux = forward(cfg, params, batch, remat=remat)
    targets = torch.as_tensor(batch["targets"], device=logits.device).long()
    if cfg.frontend == "patches":
        logits = logits[:, cfg.n_patches:]        # loss on text positions
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    loss = nll.mean() + 0.01 * aux
    return loss, {"nll": nll.mean(), "aux": aux}


# ---------------------------------------------------------------------------
# Decode (serve path)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """KV cache for attention layers and/or SSM state for mamba layers:
    k, v (L, B, max_len, KV, hd) in the config's type (the hybrid: one
    per group); conv (…, B, K-1, C) in the config's type and ssm in
    float32, with the hybrid's (groups, attn_every) leading axes.

    SWA archs keep the full length too, as the reference's code does (its
    comment speaks of a ring buffer of ``window`` entries; the code keeps
    ``max_len``)."""
    device = resolve_device(device)

    def mk(shape, dtype=cfg.torch_dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    kv = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    conv = (batch, cfg.d_conv - 1)
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.attn_every
        lead = (g, cfg.attn_every)
        return {"k": mk((g,) + kv), "v": mk((g,) + kv),
                "conv": mk(lead + conv + (cfg.d_inner + 2 * cfg.ssm_state,)),
                "ssm": mk(lead + (batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                  cfg.ssm_state), torch.float32)}
    lead = (cfg.n_layers,)
    if cfg.mixer == "mamba1":
        return {"conv": mk(lead + conv + (cfg.d_inner,)),
                "ssm": mk(lead + (batch, cfg.d_inner, cfg.ssm_state),
                          torch.float32)}
    return {"k": mk(lead + kv), "v": mk(lead + kv)}


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


def _decode_attn_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       pos: int) -> torch.Tensor:
    """The attention block of one decode step; the MoE FFN dispatches the
    batch's B tokens as one group, as the reference's decode does (its
    prefill dispatches each row on its own)."""
    h = L.apply_norm(cfg.norm, x, p.get("norm_attn"))
    x = x + _decode_attention_layer(cfg, p, h, k_cache, v_cache, pos)
    h = L.apply_norm(cfg.norm, x, p.get("norm_mlp"))
    if cfg.n_experts:
        y, _ = L.moe_ffn(h[:, 0], p["router"], p["w_gate"], p["w_up"],
                         p["w_down"], top_k=cfg.top_k,
                         capacity_factor=cfg.moe_capacity_factor)
        return x + y[:, None]
    return x + _mlp(cfg, p, h)


def _decode_mixer(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  conv: torch.Tensor, ssm_state: torch.Tensor
                  ) -> torch.Tensor:
    """One mamba layer of a decode step; its conv and ssm states (cache
    slices) are written in place."""
    h = L.apply_norm(cfg.norm, x[:, 0], p.get("norm_mixer"))
    if cfg.mixer == "mamba1":
        y, st = ssm.mamba1_step(p, h, ssm.MambaState(conv, ssm_state),
                                state=cfg.ssm_state)
    else:
        y, st = ssm.mamba2_step(p, h, ssm.Mamba2State(conv, ssm_state),
                                state=cfg.ssm_state,
                                head_dim=cfg.ssm_head_dim)
    conv.copy_(st.conv)
    ssm_state.copy_(st.ssm)
    return x + y[:, None]


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                cache: dict, pos: int) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: (B,) integer; pos: current length.

    Returns (logits (B, V) float32, cache).  Unlike the reference, which
    returns a new cache, the port writes the new position (and the SSM
    layers' new states) into ``cache`` in place and returns it.
    """
    embed = params["embed"]
    token = torch.as_tensor(token, device=embed.device).long()
    pos = int(pos)
    x = embed[token][:, None, :].to(cfg.torch_dtype)          # (B, 1, d)
    if cfg.family == "hybrid":
        for gi, gp in enumerate(_layers(params, depth=2)):
            for j, lp in enumerate(gp):
                x = _decode_mixer(cfg, lp, x, cache["conv"][gi, j],
                                  cache["ssm"][gi, j])
            # the shared attention + MLP block
            x = _decode_attn_block(cfg, params["shared"], x, cache["k"][gi],
                                   cache["v"][gi], pos)
    elif cfg.mixer == "mamba1":
        for i, lp in enumerate(_layers(params)):
            x = _decode_mixer(cfg, lp, x, cache["conv"][i],
                              cache["ssm"][i])
    else:
        for i, lp in enumerate(_layers(params)):
            x = _decode_attn_block(cfg, lp, x, cache["k"][i],
                                   cache["v"][i], pos)
    return _unembed(cfg, params, x)[:, 0].float(), cache
