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

Every entry point takes ``tp``, a ``launch.sharding.TensorParallel``
(None: one device, the code as it runs there).  With it ``params`` are
this rank's blocks under the spec tables and each layer computes on its
slice: whole query heads and the kv heads they read, an ff slice, its
experts (or the ff inside every expert), vocab rows, mamba channels or
heads.  A replicated activation enters that work through ``tp.enter``
and partial sums leave it through ``tp.sum`` (each the other's
backward), so every rank holds the same residual stream.  ``forward``
returns the rank's vocab slice of the logits and ``loss_fn`` takes a
vocab-parallel log-softmax.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import distributed as cdist
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

def _head_split(cfg: ModelConfig, tp) -> tuple:
    """(h0, h1, k0, k1, grouped): this rank's query heads [h0, h1), the kv
    heads [k0, k1) they read, and whether they form whole groups of
    query heads per kv head (on every rank alike)."""
    g = cfg.n_heads // cfg.n_kv_heads
    h0, h1 = tp.split(cfg.n_heads)
    grouped = cfg.n_heads % tp.size == 0 and (cfg.n_heads // tp.size) % g == 0
    return h0, h1, h0 // g, (h1 - 1) // g + 1, grouped


def _group_heads(cfg: ModelConfig, tp, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor):
    """q (B, S, nq, hd) -> (B, S, KV', G', hd) with k and v (B, T, KV', hd)
    of its kv heads: the rank's whole groups, else one kv head (a copy)
    per query head."""
    b, s, nq, hd = q.shape
    if tp is None:
        return q.reshape(b, s, cfg.n_kv_heads, -1, hd), k, v
    h0, h1, k0, _, grouped = _head_split(cfg, tp)
    if grouped:
        return q.reshape(b, s, k.shape[2], -1, hd), k, v
    g = cfg.n_heads // cfg.n_kv_heads
    idx = torch.tensor([(h0 + i) // g - k0 for i in range(nq)],
                       device=k.device)
    return q[:, :, :, None], k[:, :, idx], v[:, :, idx]


def _qkv_heads(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, tp=None):
    """Rotated q (B, S, nq, hd) and k, and v (B, S, nkv, hd): every head,
    or the rank's query heads and the kv heads they read."""
    b, s, _ = x.shape
    hd = cfg.hd
    if tp is None:
        wq, wk, wv = p["wq"], p["wk"], p["wv"]
    else:
        h0, h1, k0, k1, _ = _head_split(cfg, tp)
        wq = tp.take(p, "wq", 1, [(h0 * hd, h1 * hd)])
        wk = tp.take(p, "wk", 1, [(k0 * hd, k1 * hd)])
        wv = tp.take(p, "wv", 1, [(k0 * hd, k1 * hd)])
    q = (x @ wq).reshape(b, s, -1, hd)
    k = (x @ wk).reshape(b, s, -1, hd)
    v = (x @ wv).reshape(b, s, -1, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
         positions: torch.Tensor, tp=None):
    """Rotated q (B, S, KV, G, hd) and k, and v (B, S, KV, hd)."""
    return _group_heads(cfg, tp, *_qkv_heads(cfg, p, x, positions, tp))


def _wo(cfg: ModelConfig, p: dict, tp) -> torch.Tensor:
    if tp is None:
        return p["wo"]
    h0, h1, *_ = _head_split(cfg, tp)
    return tp.take(p, "wo", 0, [(h0 * cfg.hd, h1 * cfg.hd)])


def _attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, tp=None) -> torch.Tensor:
    """The attention layer; under ``tp`` the rank's heads, whose output
    projection is a partial sum."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions, tp)
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
    return out.reshape(b, s, -1) @ _wo(cfg, p, tp)


def _mlp(cfg: ModelConfig, p: dict, x: torch.Tensor,
         tp=None) -> torch.Tensor:
    """The MLP; under ``tp`` on the rank's ff slice (a partial sum)."""
    names = ("w_gate", "w_up", "w_down") if cfg.mlp == "swiglu" \
        else ("w1", "w2")
    if tp is None:
        w = [p[n] for n in names]
    else:
        ff = [tp.split(cfg.d_ff)]
        w = [tp.take(p, n, 0 if n in ("w_down", "w2") else 1, ff)
             for n in names]
    if cfg.mlp == "swiglu":
        return L.swiglu(x, *w)
    return L.gelu_mlp(x, *w)


def _experts(cfg: ModelConfig, p: dict, tp):
    """The expert weights a rank computes with and its expert range: its
    experts when the stack is expert-parallel (E % 16 == 0, the spec
    tables' rule), else the ff slice inside every expert (range None)."""
    names = ("w_gate", "w_up", "w_down")
    if tp is None:
        return [p[n] for n in names], None
    if cfg.n_experts % 16 == 0:
        e = tp.split(cfg.n_experts)
        return [tp.take(p, n, 0, [e]) for n in names], e
    ff = [tp.split(cfg.d_ff)]
    return [tp.take(p, n, 1 if n == "w_down" else 2, ff)
            for n in names], None


def _attn_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, tp=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm attention + FFN/MoE block. Returns (x, aux_loss)."""
    h = L.apply_norm(cfg.norm, x, p.get("norm_attn"))
    if tp is None:
        x = x + _attention(cfg, p, h, positions)
    else:
        x = x + tp.sum(_attention(cfg, p, tp.enter(h), positions, tp))
    h = L.apply_norm(cfg.norm, x, p.get("norm_mlp"))
    if cfg.n_experts:
        w, experts = _experts(cfg, p, tp)
        y, aux = L.moe_ffn_batched(h, p["router"], *w, top_k=cfg.top_k,
                                   capacity_factor=cfg.moe_capacity_factor,
                                   tp=tp, experts=experts)
        return x + y, aux
    zero = torch.zeros((), device=x.device)
    if tp is None:
        return x + _mlp(cfg, p, h), zero
    return x + tp.sum(_mlp(cfg, p, tp.enter(h), tp)), zero


def _mamba1_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  chunk: int, tp=None) -> torch.Tensor:
    h = L.apply_norm(cfg.norm, x, p.get("norm_mixer"))
    y = ssm.mamba1_forward(p, h, state=cfg.ssm_state, chunk=chunk, tp=tp)
    return x + (y if tp is None else tp.sum(y))


def _mamba2_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  chunk: int, tp=None) -> torch.Tensor:
    h = L.apply_norm(cfg.norm, x, p.get("norm_mixer"))
    y = ssm.mamba2_forward(p, h, state=cfg.ssm_state,
                           head_dim=cfg.ssm_head_dim, chunk=chunk, tp=tp)
    return x + (y if tp is None else tp.sum(y))


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


def _vocab_rows(cfg: ModelConfig, params: Params, name: str, tp):
    """``params[name]`` (vocab, d), or under ``tp`` the rank's rows and
    their first id."""
    if tp is None:
        return params[name], 0
    v0, v1 = tp.split(cfg.vocab)
    return tp.top.take(params, name, 0, [(v0, v1)]), v0


def _unembed(cfg: ModelConfig, params: Params, x: torch.Tensor, tp=None):
    """Logits of x; under ``tp`` of the rank's vocab rows."""
    x = L.apply_norm(cfg.norm, x, params.get("final_norm"))
    name = "unembed" if "unembed" in params else "embed"
    unembed, _ = _vocab_rows(cfg, params, name, tp)
    if tp is not None:
        x = tp.enter(x)
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


def _embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  tp=None) -> torch.Tensor:
    """The embedding of integer ``tokens``; under ``tp`` each rank looks up
    the ids of its vocab rows and the parts are summed."""
    embed, v0 = _vocab_rows(cfg, params, "embed", tp)
    if tp is None:
        return embed[tokens]
    local = tokens - v0
    inside = (local >= 0) & (local < embed.shape[0])
    x = embed[local.clamp(0, embed.shape[0] - 1)] * \
        inside[..., None].to(embed.dtype)
    return tp.sum(x)


def _embed_inputs(cfg: ModelConfig, params: Params, batch: dict, tp=None
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
        x = _embed_tokens(cfg, params, field("tokens").long(), tp)
        if cfg.frontend == "patches":
            pat = field("patches").to(dtype) @ params["patch_proj"]
            x = torch.cat([pat, x], dim=1)
    b, s, _ = x.shape
    return x.to(dtype), torch.arange(s, device=dev).expand(b, s)


def forward(cfg: ModelConfig, params: Params, batch: dict,
            remat: bool = True, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits. Returns (logits (B,S,V), aux_loss); under
    ``tp`` the logits of the rank's vocab rows (``tp.gather_uneven``
    makes them whole).

    ``batch``: ``tokens`` (B, S) integer token ids; the audio frontend
    takes ``frames`` (B, S, d) instead, the VLM frontend ``patches`` (B,
    n_patches, d) besides ``tokens`` (B, S - n_patches).  With ``remat``
    and gradients on, each layer keeps only its input for the backward
    pass and is run again there (``torch.utils.checkpoint``,
    non-reentrant), as the reference's ``jax.checkpoint`` around each
    layer body (the hybrid: each group, and each mamba layer inside it):
    on the window path the attention kernel then launches twice a layer
    and step, and a layer's collectives run again.  Without
    gradients (``torch.inference_mode()``, the prefill) ``remat`` changes
    nothing.
    """
    x, positions = _embed_inputs(cfg, params, batch, tp)
    aux = torch.zeros((), device=x.device)
    recompute = remat and torch.is_grad_enabled()
    lt = None if tp is None else tp.layers
    if cfg.family == "hybrid":
        x = _hybrid_stack(cfg, params, x, positions, recompute, tp)
    elif cfg.mixer == "mamba1":
        chunk = 1024 if cfg.cost_mode else 256
        for lp in _layers(params):
            x = _run(recompute, _mamba1_block, cfg, lp, x, chunk, lt)
    else:
        for lp in _layers(params):
            x, a = _run(recompute, _attn_block, cfg, lp, x, positions, lt)
            aux = aux + a
    return _unembed(cfg, params, x, tp), aux


def _hybrid_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
                  positions: torch.Tensor, recompute: bool,
                  tp=None) -> torch.Tensor:
    chunk = 512 if cfg.cost_mode else 128
    lt, st = (None, None) if tp is None else (tp.layers, tp.shared)

    def group(gp: list, x: torch.Tensor) -> torch.Tensor:
        for lp in gp:
            x = _run(recompute, _mamba2_block, cfg, lp, x, chunk, lt)
        # shared attention + MLP block (single parameter set, reused)
        return _attn_block(cfg, params["shared"], x, positions, st)[0]

    for gp in _layers(params, depth=2):
        x = _run(recompute, group, gp, x)
    return x


def _vocab_parallel_nll(tp, logits: torch.Tensor,
                        targets: torch.Tensor, vocab: int) -> torch.Tensor:
    """-log softmax(logits)[target] from every rank's vocab slice: the
    max and the sum of exponentials over all ranks, the target's logit
    from the rank that holds it."""
    lf = logits.float()
    m = tp.max(lf.amax(-1, keepdim=True))
    sumexp = tp.sum((lf - m).exp().sum(-1))
    v0, _ = tp.split(vocab)
    local = targets - v0
    inside = (local >= 0) & (local < lf.shape[-1])
    t = lf.gather(-1, local.clamp(0, lf.shape[-1] - 1)[..., None])[..., 0]
    t = tp.sum(torch.where(inside, t, torch.zeros_like(t)))
    return m[..., 0] + sumexp.log() - t


def loss_fn(cfg: ModelConfig, params: Params, batch: dict,
            remat: bool = True, tp=None) -> tuple[torch.Tensor, dict]:
    """Mean next-token negative log-likelihood (+ 0.01 aux).  Returns
    (loss, {"nll", "aux"}); ``batch["targets"]``: (B, S) token ids, over
    the text positions only for the VLM frontend.  Under ``tp`` the
    log-softmax runs over the vocab-parallel logits."""
    logits, aux = forward(cfg, params, batch, remat=remat, tp=tp)
    targets = torch.as_tensor(batch["targets"], device=logits.device).long()
    if cfg.frontend == "patches":
        logits = logits[:, cfg.n_patches:]        # loss on text positions
    if tp is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
    else:
        nll = _vocab_parallel_nll(tp, logits, targets, cfg.vocab)
    loss = nll.mean() + 0.01 * aux
    return loss, {"nll": nll.mean(), "aux": aux}


# ---------------------------------------------------------------------------
# Decode (serve path)
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """``{name: (shape, dtype)}`` of the cache of :func:`init_cache`."""
    dt = cfg.torch_dtype
    kv = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    conv = (batch, cfg.d_conv - 1)
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.attn_every
        lead = (g, cfg.attn_every)
        return {"k": ((g,) + kv, dt), "v": ((g,) + kv, dt),
                "conv": (lead + conv + (cfg.d_inner + 2 * cfg.ssm_state,),
                         dt),
                "ssm": (lead + (batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), torch.float32)}
    lead = (cfg.n_layers,)
    if cfg.mixer == "mamba1":
        return {"conv": (lead + conv + (cfg.d_inner,), dt),
                "ssm": (lead + (batch, cfg.d_inner, cfg.ssm_state),
                        torch.float32)}
    return {"k": (lead + kv, dt), "v": (lead + kv, dt)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None, mesh=None) -> dict:
    """KV cache for attention layers and/or SSM state for mamba layers:
    k, v (L, B, max_len, KV, hd) in the config's type (the hybrid: one
    per group); conv (…, B, K-1, C) in the config's type and ssm in
    float32, with the hybrid's (groups, attn_every) leading axes.  On a
    DeviceMesh ``mesh``, this rank's block of each by
    ``launch.sharding.cache_specs``.

    SWA archs keep the full length too, as the reference's code does (its
    comment speaks of a ring buffer of ``window`` entries; the code keeps
    ``max_len``)."""
    device = resolve_device(device)
    shapes = cache_shapes(cfg, batch, max_len)
    if mesh is not None:
        from repro_torch.launch.sharding import block_slices, cache_specs
        specs = cache_specs(cfg, mesh, batch, max_len)
        shapes = {k: (tuple(n for _, n in block_slices(shape, specs[k],
                                                       mesh)), dt)
                  for k, (shape, dt) in shapes.items()}
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in shapes.items()}


def _cache_dim(tp, name: str, depth: int):
    """The per-layer dims of a cache leaf that the model and the batch
    axes shard under ``tp.cache`` (None where unsharded)."""
    spec = tp.cache[name][depth:]
    model = [i for i, e in enumerate(spec) if e == "model"]
    batch = [i for i, e in enumerate(spec) if e not in (None, "model")]
    return (model[0] if model else None), (batch[0] if batch else None)


def _write_pos(cache: torch.Tensor, value: torch.Tensor, pos: int,
               offset: int) -> None:
    """cache[:, pos - offset] = value where pos falls in this block."""
    if offset <= pos < offset + cache.shape[1]:
        cache[:, pos - offset] = value.to(cache.dtype)


def _decode_attention_tp(cfg: ModelConfig, p: dict, x: torch.Tensor,
                         k_cache: torch.Tensor, v_cache: torch.Tensor,
                         pos: int, tp, depth: int) -> torch.Tensor:
    """The rank's heads of one decode step's attention (a partial sum of
    the output projection).  Its k and v cache blocks follow
    ``tp.cache``: when they are the kv heads its query heads read, the
    step writes and reads them; else it writes its block of every kv head's
    new k and v and reads its heads from the blocks all-gathered over the
    model group.  A sequence-sharded cache (a batch of 1) holds positions
    ``[offset, offset + T)``; attention combines its softmax over the batch
    group."""
    b, hd = x.shape[0], cfg.hd
    posb = torch.full((b, 1), pos, device=x.device)
    h0, h1, k0, k1, _ = _head_split(cfg, tp)
    mdim, bdim = _cache_dim(tp, "k", depth)
    seq = bdim == 1
    offset = tp.batch_index * k_cache.shape[1] if seq else 0
    direct = mdim == 2 and k_cache.shape[2] == k1 - k0 and \
        k0 == tp.rank * (k1 - k0)
    wq = tp.take(p, "wq", 1, [(h0 * hd, h1 * hd)])
    q = L.apply_rope((x @ wq).reshape(b, 1, -1, hd), posb, cfg.rope_theta)
    kv_range = [(k0 * hd, k1 * hd)] if direct else [(0, cfg.n_kv_heads * hd)]
    k, v = ((x @ tp.take(p, n, 1, kv_range)).reshape(b, 1, -1, hd)
            for n in ("wk", "wv"))
    k = L.apply_rope(k, posb, cfg.rope_theta)
    if not direct and mdim is not None:
        n = k_cache.shape[mdim]
        k, v = (t.narrow(mdim, tp.rank * n, n) for t in (k, v))
    _write_pos(k_cache, k[:, 0], pos, offset)
    _write_pos(v_cache, v[:, 0], pos, offset)
    kc, vc = k_cache, v_cache
    if not direct:
        if mdim is not None:
            kc, vc = (tp.gather(c, mdim) for c in (k_cache, v_cache))
        kc, vc = kc[:, :, k0:k1], vc[:, :, k0:k1]
    q, kc, vc = _group_heads(cfg, tp, q, kc, vc)
    out = L.decode_attention(q, kc, vc, pos, window=cfg.swa_window,
                             offset=offset,
                             group=tp.batch_group if seq else None,
                             stats=tp.stats)
    return out.reshape(b, 1, -1) @ _wo(cfg, p, tp)


def _decode_attention_layer(cfg: ModelConfig, p: dict, x: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            pos: int, tp=None, depth: int = 1
                            ) -> torch.Tensor:
    """x: (B, 1, d); caches (B, T, KV, hd), written at ``pos`` in place."""
    if tp is not None:
        return tp.sum(_decode_attention_tp(cfg, p, x, k_cache, v_cache,
                                           pos, tp, depth))
    b = x.shape[0]
    posb = torch.full((b, 1), pos, device=x.device)
    q, k, v = _qkv(cfg, p, x, posb)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    out = L.decode_attention(q, k_cache, v_cache, pos,
                             window=cfg.swa_window)
    return out.reshape(b, 1, -1) @ p["wo"]


def _decode_moe(cfg: ModelConfig, p: dict, h: torch.Tensor, tp
                ) -> torch.Tensor:
    """The MoE FFN of a decode step over the batch as one group: under
    ``tp`` with the batch sharded, over every rank's rows (gathered over
    the batch group), the rank's own rows returned."""
    w, experts = _experts(cfg, p, tp)
    rows = tp is not None and tp.batch_group is not None and \
        tp.cache_batch > 1
    if rows:
        n = h.shape[0]
        h = cdist.all_gather_along(tp.batch_group, h, 0, tp.stats)
    y, _ = L.moe_ffn(h, p["router"], *w, top_k=cfg.top_k,
                     capacity_factor=cfg.moe_capacity_factor, tp=tp,
                     experts=experts)
    if rows:
        y = y[tp.batch_index * n:(tp.batch_index + 1) * n]
    return y


def _decode_attn_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       pos: int, tp=None, depth: int = 1) -> torch.Tensor:
    """The attention block of one decode step; the MoE FFN dispatches the
    batch's B tokens as one group, as the reference's decode does (its
    prefill dispatches each row on its own)."""
    h = L.apply_norm(cfg.norm, x, p.get("norm_attn"))
    x = x + _decode_attention_layer(cfg, p, h, k_cache, v_cache, pos, tp,
                                    depth)
    h = L.apply_norm(cfg.norm, x, p.get("norm_mlp"))
    if cfg.n_experts:
        return x + _decode_moe(cfg, p, h[:, 0], tp)[:, None]
    if tp is None:
        return x + _mlp(cfg, p, h)
    return x + tp.sum(_mlp(cfg, p, h, tp))


def _rows_of(tp, cache: torch.Tensor, bdim: Optional[int]):
    """This rank's batch rows of an SSM cache block that holds the whole
    batch on every batch rank (its specs shard no batch dim), else the
    block; and whether they were cut."""
    cut = tp is not None and tp.batch_group is not None and \
        tp.cache_batch > 1 and bdim is None
    if not cut:
        return cache, False
    n = cache.shape[0] // tp.n_batch
    return cache[tp.batch_index * n:(tp.batch_index + 1) * n], True


def _decode_mixer(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  conv: torch.Tensor, ssm_state: torch.Tensor, tp=None,
                  depth: int = 1) -> torch.Tensor:
    """One mamba layer of a decode step; its conv and ssm states (cache
    slices) are written in place.  Under ``tp`` the rank runs its
    channels (mamba1) or heads (mamba2); SSM caches hold every batch row
    on each batch rank, so the new rows are all-gathered over the batch
    group."""
    h = L.apply_norm(cfg.norm, x[:, 0], p.get("norm_mixer"))
    bdim = None if tp is None else _cache_dim(tp, "conv", depth)[1]
    conv_r, cut = _rows_of(tp, conv, bdim)
    ssm_r, _ = _rows_of(tp, ssm_state, bdim)
    conv_in = conv_r
    if tp is not None and cfg.mixer == "mamba2":
        whole = tp.gather(conv_r, conv_r.dim() - 1)
        conv_in = whole[..., ssm.mamba2_conv_channels(tp)]
    if cfg.mixer == "mamba1":
        y, st = ssm.mamba1_step(p, h, ssm.MambaState(conv_in, ssm_r),
                                state=cfg.ssm_state, tp=tp)
    else:
        y, st = ssm.mamba2_step(p, h, ssm.Mamba2State(conv_in, ssm_r),
                                state=cfg.ssm_state,
                                head_dim=cfg.ssm_head_dim, tp=tp)
    new_conv = st.conv
    if tp is not None and cfg.mixer == "mamba2":
        new_conv = ssm.mamba2_conv_block(tp, whole, st.conv, conv_r.shape[-1])
    if cut:
        new_conv = cdist.all_gather_along(tp.batch_group, new_conv, 0,
                                          tp.stats)
        new = cdist.all_gather_along(tp.batch_group, st.ssm, 0, tp.stats)
    else:
        new = st.ssm
    conv.copy_(new_conv)
    ssm_state.copy_(new)
    return x + (y if tp is None else tp.sum(y))[:, None]


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                cache: dict, pos: int, tp=None) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: (B,) integer; pos: current length.

    Returns (logits (B, V) float32, cache).  Unlike the reference, which
    returns a new cache, the port writes the new position (and the SSM
    layers' new states) into ``cache`` in place and returns it.  Under
    ``tp`` (``launch.sharding.ServeStep``) ``params`` and ``cache`` are
    this rank's blocks and the logits cover the whole vocabulary.
    """
    embed = params["embed"]
    token = torch.as_tensor(token, device=embed.device).long()
    pos = int(pos)
    x = _embed_tokens(cfg, params, token, tp)[:, None, :].to(
        cfg.torch_dtype)                                      # (B, 1, d)
    lt, st = (None, None) if tp is None else (tp.layers, tp.shared)
    if cfg.family == "hybrid":
        for gi, gp in enumerate(_layers(params, depth=2)):
            for j, lp in enumerate(gp):
                x = _decode_mixer(cfg, lp, x, cache["conv"][gi, j],
                                  cache["ssm"][gi, j], lt, depth=2)
            # the shared attention + MLP block
            x = _decode_attn_block(cfg, params["shared"], x, cache["k"][gi],
                                   cache["v"][gi], pos, st)
    elif cfg.mixer == "mamba1":
        for i, lp in enumerate(_layers(params)):
            x = _decode_mixer(cfg, lp, x, cache["conv"][i],
                              cache["ssm"][i], lt)
    else:
        for i, lp in enumerate(_layers(params)):
            x = _decode_attn_block(cfg, lp, x, cache["k"][i],
                                   cache["v"][i], pos, lt)
    logits = _unembed(cfg, params, x, tp)[:, 0].float()
    if tp is not None:
        logits = tp.gather_uneven(logits, -1, cfg.vocab)
    return logits, cache
