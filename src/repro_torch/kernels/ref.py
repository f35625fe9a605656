"""Plain PyTorch versions of the CUDA kernels (the CPU path and the oracle).

Each function computes what its kernel computes, with the same float32
accumulation and output type, and runs on any device.  The kernels'
wrappers in :mod:`repro_torch.kernels.ops` take these for CPU tensors;
``chip_smoke.py`` holds every kernel against them on the card.
"""
from __future__ import annotations

import torch


def batched_gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(P, bs, bs) @ (P, bs, bs) -> (P, bs, bs), f32 accumulation."""
    return torch.einsum("pik,pkj->pij", a.float(), b.float()).to(a.dtype)


def bsmm_pairs_ref(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
                   sa: torch.Tensor, sb: torch.Tensor, seg: torch.Tensor,
                   cap_c: int) -> torch.Tensor:
    """Gather-GEMM-scatter oracle.

    a_blocks : (capA, bs, bs) packed A blocks
    b_blocks : (capB, bs, bs) packed B blocks
    sa, sb   : (P,) slot ids per pair, within range
    seg      : (P,) output slot per pair, ascending; cap_c marks invalid
    returns  : (cap_c, bs, bs) accumulated C blocks, in a_blocks.dtype

    Products and their sums stay float32 until the final cast (the
    kernel's contract); the invalid pairs land in a trailing segment that
    is dropped.
    """
    bs = a_blocks.shape[1]
    prods = torch.einsum("pik,pkj->pij", a_blocks[sa.long()].float(),
                         b_blocks[sb.long()].float())
    out = torch.zeros((cap_c + 1, bs, bs), dtype=torch.float32,
                      device=a_blocks.device)
    out.index_add_(0, seg.long().clamp(max=cap_c), prods)
    return out[:cap_c].to(a_blocks.dtype)


def band_mask(s: int, window: int, causal: bool = True,
              device=None) -> torch.Tensor:
    """(S, S) bool: query i attends key j iff |i - j| < window, and
    j <= i when causal."""
    return torch.ones((s, s), dtype=torch.bool, device=device).triu(
        -(window - 1)).tril(0 if causal else window - 1)


def banded_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: int, causal: bool = True) -> torch.Tensor:
    """Sliding-window attention oracle.

    q : (H, S, D); k, v : (H_kv, S, D) with H_kv dividing H: query head h
    reads kv head ``h // (H // H_kv)`` (grouped-query attention; H_kv == H
    is ordinary multi-head attention).  window counts key positions
    attended to the left (inclusive of self): position i attends keys in
    [i-window+1, i] (causal) or |i - j| < window (bidirectional).

    A dense masked softmax, entirely in float32 (scores, their 1/sqrt(D)
    scale, the softmax and ``p @ v``), cast to q's type once at the end:
    the rounding of the Pallas kernel and of the CUDA kernel.  The
    reference's oracle (``repro/kernels/ref.py``) rounds the scaled
    scores and ``p`` to q's type as well, so in bfloat16 the two differ
    by a few ulps.
    """
    d = q.shape[-1]
    group = q.shape[0] // max(k.shape[0], 1)
    if group > 1:
        k, v = (t.repeat_interleave(group, dim=0) for t in (k, v))
    scores = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * (
        1.0 / d ** 0.5)
    mask = band_mask(q.shape[1], window, causal, device=q.device)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("hqk,hkd->hqd", probs, v.float()).to(q.dtype)


def banded_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor, window: int,
                             causal: bool = True) -> tuple:
    """``(dq, dk, dv)`` of :func:`banded_attention_ref` at ``(q, k, v)`` for
    the output gradient ``do``: autograd through the plain version in
    float32, each gradient cast to its input's type once at the end.  dk
    and dv are (H_kv, S, D), summed over each kv head's query heads."""
    with torch.enable_grad():
        q32, k32, v32 = (t.detach().float().requires_grad_()
                         for t in (q, k, v))
        out = banded_attention_ref(q32, k32, v32, window, causal=causal)
        dq, dk, dv = torch.autograd.grad(out, (q32, k32, v32), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
