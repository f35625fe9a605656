"""Shared model layers: norms, RoPE, attention variants, MLP.

The port of ``repro/models/layers.py``.  Attention comes in three paths:

* ``chunked_attention`` — full (causal or bidirectional) attention computed
  blockwise with an online softmax over kv chunks; peak memory
  O(S * q_chunk) per head instead of O(S^2).  Plain PyTorch.
* ``windowed_attention`` — the paper's *banded block-sparse* case: each
  query attends only the keys inside the sliding window, O(S * W) work.
  It runs the hand-written CUDA kernel ``banded_attention`` on the card
  (``repro_torch.kernels.ops``), its plain version on the CPU.
* ``decode_attention`` — single-position attention against a KV cache.
  Plain PyTorch.

All keep float32 softmax numerics regardless of activation dtype.  The
MoE FFN (``moe_ffn``, ``moe_ffn_batched``) is the reference's
capacity-bounded gather-GEMM-scatter dispatch in plain PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.distributed import all_reduce
from repro_torch.kernels import ops

_NEG = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with the reference's ``1 + scale`` convention (zeros are the
    identity)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * (1.0 + scale.float())
    return out.to(x.dtype)


def nonparam_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: no scale, no bias."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, scale: Optional[torch.Tensor]
               ) -> torch.Tensor:
    if kind == "nonparam_ln":
        return nonparam_layer_norm(x)
    return rms_norm(x, scale)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, n_heads, hd); positions: (..., S).  Half-split rotation:
    the first and second halves of ``hd`` are the pairs' two parts."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)      # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # head axis
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention variants
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_chunk: int = 512,
                      kv_chunk: int = 1024,
                      unroll: bool = False) -> torch.Tensor:
    """Flash-pattern full attention.

    q: (B, S, KV, G, hd); k, v: (B, S, KV, hd).  Returns (B, S, KV, G, hd).
    Memory per step: O(q_chunk * kv_chunk) scores per (KV, G).  ``unroll``
    is the reference's compile switch and has no effect here.
    """
    b, s, kvh, g, hd = q.shape
    t = k.shape[1]
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, t)
    assert s % q_chunk == 0 and t % kv_chunk == 0
    nq, nk = s // q_chunk, t // kv_chunk
    scale = 1.0 / (hd ** 0.5)
    dev = q.device

    chunks = []
    for iq in range(nq):
        # (B, qc, KV, G, hd)
        qi = q[:, iq * q_chunk:(iq + 1) * q_chunk] * scale
        m = torch.full((b, kvh, g, q_chunk), _NEG, device=dev)
        l = torch.zeros((b, kvh, g, q_chunk), device=dev)
        acc = torch.zeros((b, kvh, g, q_chunk, hd), device=dev)
        for jk in range(nk):
            kj = k[:, jk * kv_chunk:(jk + 1) * kv_chunk]
            vj = v[:, jk * kv_chunk:(jk + 1) * kv_chunk]
            s_ij = torch.einsum("bqvgh,bkvh->bvgqk", qi.float(), kj.float())
            if causal:
                qpos = iq * q_chunk + torch.arange(q_chunk,
                                                   device=dev)[:, None]
                kpos = jk * kv_chunk + torch.arange(kv_chunk,
                                                    device=dev)[None, :]
                s_ij = torch.where(qpos >= kpos, s_ij, _NEG)
            m_new = torch.maximum(m, s_ij.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s_ij - m_new[..., None])
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + torch.einsum(
                "bvgqk,bkvh->bvgqh", p, vj.float())
            m = m_new
        out = acc / (l[..., None] + 1e-30)          # (B, KV, G, qc, hd)
        chunks.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(chunks, dim=1)


def windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       window: int, causal: bool = True,
                       block: int = 512) -> torch.Tensor:
    """Banded block-sparse attention (paper's banded case, §5.1).

    Each query attends the keys within ``window`` positions (to its left
    when causal): O(S * W) work.  q: (B, S, KV, G, hd); k, v: (B, S, KV,
    hd).  The heads go to :func:`repro_torch.kernels.ops.banded_attention`
    as q (B*KV*G, S, hd) and k, v (B*KV, S, hd): query head (b, kv, g)
    reads kv head (b, kv), so k and v are not copied over the group.
    ``block`` only has to meet the reference's contract.
    """
    b, s, kvh, g, hd = q.shape
    block = min(block, s)
    assert s % block == 0 and window % block == 0

    def heads_first(x):     # (B, S, KV, ..., hd) -> (B*KV*..., S, hd)
        # a copy: at B = 1 the reshape alone would be a strided view
        x = x.movedim(1, -2).contiguous()
        return x.view(-1, s, hd)

    qh, kh, vh = heads_first(q), heads_first(k), heads_first(v)
    out = ops.banded_attention(qh, kh, vh, window=window, block_q=block,
                               block_kv=block, causal=causal)
    return out.reshape(b, kvh, g, s, hd).permute(0, 3, 1, 2, 4)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     window: int = 0, offset: int = 0, group=None,
                     stats=None) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, KV, G, hd); caches: (B, T, KV, hd); pos: current length.
    window > 0 restricts to the last ``window`` positions (SWA decode).
    A cache sharded along the sequence holds positions [offset, offset +
    T) on each rank of ``group``: the softmax's max and sum of
    exponentials, and the weighted values, are summed over the group.
    """
    b, _, kvh, g, hd = q.shape
    t = k_cache.shape[1]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bovgh,btvh->bvgt", (q * scale).float(),
                     k_cache.float())
    idx = offset + torch.arange(t, device=q.device)
    valid = idx <= pos
    if window:
        valid = valid & (idx > pos - window)
    s = torch.where(valid, s, _NEG)
    if group is None:
        p = torch.softmax(s, dim=-1)
    else:
        m = all_reduce(group, s.amax(-1, keepdim=True), stats,
                       op=dist.ReduceOp.MAX)
        e = torch.exp(s - m)
        p = e / all_reduce(group, e.sum(-1, keepdim=True), stats)
    out = torch.einsum("bvgt,btvh->bvgh", p.to(q.dtype), v_cache)
    if group is not None:
        out = all_reduce(group, out, stats)
    return out.reshape(b, 1, kvh, g, hd)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def gelu_mlp(x, w1, w2):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ w1, approximate="tanh") @ w2


_MOE_RESHARD_AXIS = [None]


def set_moe_reshard_axis(axis) -> None:
    """The reference's launcher hook: reshard MoE hidden activations onto
    ``axis`` (a mesh axis name; None, the default, turns it off) before
    the down-projection.  In the reference it is a layout constraint for
    GSPMD; the port has no GSPMD and stores the axis without changing
    the computation: ff-sharded experts always sum the down-projection's
    outputs with one all-reduce over the model group (see
    :func:`_moe_rows`), and expert-parallel layers the same."""
    _MOE_RESHARD_AXIS[0] = axis


# ---------------------------------------------------------------------------
# Mixture of Experts — capacity-bounded gather-GEMM-scatter dispatch.
# The same static-capacity pattern as core/bsmm.py: expert assignment is the
# dynamic block occupancy; tokens are gathered per expert, multiplied as one
# batched product over the stacked expert weights, and scattered back.
# ---------------------------------------------------------------------------

def moe_route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """The router: float32 logits, softmax, the top-k experts of each
    token and their gates renormalised.  x (..., d) -> (probs (..., E),
    gate_vals (..., k), exp_idx (..., k))."""
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    gate_vals, exp_idx = probs.topk(top_k, dim=-1)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, exp_idx


def _moe_rows(x: torch.Tensor, router_w, w_gate, w_up, w_down, *,
              top_k: int, capacity_factor: float, tp=None, experts=None):
    """The reference's ``moe_ffn`` on each row of x (B, T, d) on its own:
    each row has its own capacity slots, all rows share one product per
    expert weight.  Returns (out (B, T, d), aux (B,)).

    Under ``tp`` the routing is replicated (every rank computes the same
    capacity and drops) and each rank runs its experts ``experts`` = (e0,
    e1), or, with ``experts`` None, the ff slice its weights hold of
    every expert; the outputs are summed over the model group."""
    b, t, d = x.shape
    e = router_w.shape[1]
    cap = int(capacity_factor * top_k * t / e) + 1
    cap = ((cap + 15) // 16) * 16   # the reference's TP-shardable buffers

    probs, gate_vals, exp_idx = moe_route(x, router_w, top_k)

    # load-balancing auxiliary loss (Switch-style); ce carries no gradient
    flat_e = exp_idx.reshape(b, t * top_k)                   # (B, T*k)
    onehot = F.one_hot(flat_e, e)                            # (B, T*k, E)
    ce = onehot.sum(1).float() / (t * top_k)
    aux = e * (probs.mean(1) * ce).sum(-1)

    # position of each (token, slot) within its expert: a running count in
    # token-major, slot-minor order, which decides the pairs dropped
    my_pos = (onehot.cumsum(1) - 1).gather(2, flat_e[..., None])[..., 0]
    rows = torch.arange(b, device=x.device)[:, None]
    # expert ex of row r owns slots (ex * B + r) * cap ...; dropped pairs
    # are parked in the last row, which is never read
    dest = torch.where(my_pos < cap, (flat_e * b + rows) * cap + my_pos,
                       e * b * cap).reshape(-1)
    if tp is not None:
        x, gate_vals = tp.enter(x), tp.enter(gate_vals)

    src = x.repeat_interleave(top_k, dim=1).reshape(-1, d)
    buf = x.new_zeros((e * b * cap + 1, d)).index_add(0, dest, src)
    xe = buf[:-1].view(e, b * cap, d)
    if experts is not None:
        xe = xe[experts[0]:experts[1]]
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down)                                # (E, B*cap, d)
    if experts is not None:
        ye = F.pad(ye, (0, 0, 0, 0, experts[0], e - experts[1]))
    flat = ye.reshape(-1, d)

    # combine: gather back (dropped pairs read an appended zero row) and
    # weight by the gate in x's type
    flat_back = torch.cat([flat, x.new_zeros((1, d))])
    y = flat_back[dest] * gate_vals.reshape(-1, 1).to(x.dtype)
    out = y.view(b, t, top_k, d).sum(2)
    return (out if tp is None else tp.sum(out)), aux


def moe_ffn_batched(x: torch.Tensor, router_w, w_gate, w_up, w_down, *,
                    top_k: int, capacity_factor: float = 1.25, tp=None,
                    experts=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-batch-row dispatch: x (B, S, d) -> (B, S, d), as the reference's
    ``vmap`` of :func:`moe_ffn` over B: each row is routed with its own
    capacity.  Returns (out, mean aux over the rows); ``tp`` and
    ``experts`` as in :func:`_moe_rows`."""
    out, aux = _moe_rows(x, router_w, w_gate, w_up, w_down, top_k=top_k,
                         capacity_factor=capacity_factor, tp=tp,
                         experts=experts)
    return out, aux.mean()


def moe_ffn(x: torch.Tensor, router_w, w_gate, w_up, w_down, *,
            top_k: int, capacity_factor: float = 1.25, tp=None,
            experts=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d); router_w: (d, E); expert weights: (E, d, ff)/(E, ff, d).

    Returns (out (T, d), aux_loss ()).  Tokens over capacity are dropped
    (contribute zero) — the standard static-shape MoE contract.
    """
    out, aux = _moe_rows(x[None], router_w, w_gate, w_up, w_down,
                         top_k=top_k, capacity_factor=capacity_factor,
                         tp=tp, experts=experts)
    return out[0], aux[0]
