"""Public wrappers around the CUDA kernels, dispatched by device.

A CUDA tensor goes to the hand-written kernel (built at first use); a CPU
tensor goes to the plain version in :mod:`repro_torch.kernels.ref`, which
is how the tests run here.  There is no fallback: a CUDA tensor never
reaches the plain version, and a kernel that fails to build or launch
raises.  Tensors on any other device are refused.  The contract of each
op is defined by kernels/ref.py.

``banded_attention`` is differentiable on both devices through one
``torch.autograd.Function``: its backward runs the hand-written backward
kernel (``csrc/block_attention_bwd.cu``) on CUDA tensors and the plain
backward (``ref.banded_attention_bwd_ref``) on CPU tensors.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import LAUNCHES, VARIANT_LAUNCHES
from .batched_gemm import batched_gemm as _batched_gemm_kernel
from .block_attention import banded_attention as _banded_attention_kernel
from .block_attention import check_heads
from .block_attention_bwd import banded_attention_bwd as _banded_bwd_kernel
from .bsmm_pairs import bsmm_pairs as _bsmm_pairs_kernel

__all__ = ["LAUNCHES", "VARIANT_LAUNCHES", "banded_attention",
           "batched_gemm", "bsmm_pairs"]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def batched_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[p] = A[p] @ B[p]; (P, bs, bs) each, f32 accumulation."""
    if _on_cuda(a):
        return _batched_gemm_kernel(a, b)
    return ref.batched_gemm_ref(a, b)


def bsmm_pairs(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
               sa: torch.Tensor, sb: torch.Tensor, seg: torch.Tensor, *,
               cap_c: int) -> torch.Tensor:
    """C[seg[p]] += A[sa[p]] @ B[sb[p]]; seg ascending, cap_c = invalid.

    Slot ids are clamped into range (invalid pairs may point anywhere;
    the kernel clamps them as it reads them), and C slots that no pair
    visits come back zero.
    """
    if _on_cuda(a_blocks):
        return _bsmm_pairs_kernel(a_blocks, b_blocks, sa, sb, seg,
                                  cap_c=cap_c)
    sa = sa.clamp(0, max(a_blocks.shape[0] - 1, 0))
    sb = sb.clamp(0, max(b_blocks.shape[0] - 1, 0))
    return ref.bsmm_pairs_ref(a_blocks, b_blocks, sa, sb, seg, cap_c)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, block_q: int = 128, block_kv: int = 128,
                     causal: bool = True) -> torch.Tensor:
    """Sliding-window attention, (H, S, D) -> (H, S, D).

    k and v are (H_kv, S, D) with H_kv dividing H (grouped-query
    attention: query head h reads kv head ``h // (H // H_kv)``).  The
    reference's block contract holds on every device: square blocks
    (``block_q == block_kv``), ``S`` a multiple of the block and
    ``window`` a multiple of ``block_kv``.  The result does not depend on
    the blocks (the mask is per element), so neither the kernel nor the
    plain version reads them.  Differentiable in q, k and v on both
    devices (:class:`_BandedAttention`).
    """
    check_heads(q, k, v)
    s = q.shape[1]
    if block_q != block_kv:
        raise ValueError(f"banded_attention assumes square q/kv blocks, got "
                         f"block_q={block_q} block_kv={block_kv}")
    if s % block_q:
        raise ValueError(f"banded_attention: S={s} is not a multiple of the "
                         f"block {block_q}")
    if window % block_kv:
        raise ValueError(f"banded_attention: window={window} is not a "
                         f"multiple of block_kv={block_kv}")
    return _BandedAttention.apply(q, k, v, window, causal)


class _BandedAttention(torch.autograd.Function):
    """The kernel (CUDA) or the plain version (CPU) forward; the backward
    kernel or the plain backward, on the forward's saved q, k and v (both
    recompute the softmax; neither reads the forward's output)."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        if _on_cuda(q):
            out = _banded_attention_kernel(q, k, v, window=window,
                                           causal=causal)
        else:
            out = ref.banded_attention_ref(q, k, v, window, causal=causal)
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if _on_cuda(q):
            dq, dk, dv = _banded_bwd_kernel(q, k, v, do.contiguous(),
                                            window=ctx.window,
                                            causal=ctx.causal)
        else:
            dq, dk, dv = ref.banded_attention_bwd_ref(
                q, k, v, do, ctx.window, causal=ctx.causal)
        return dq, dk, dv, None, None
