"""Public wrappers around the CUDA kernels, dispatched by device.

A CUDA tensor goes to the hand-written kernel (built at first use); a CPU
tensor goes to the plain version in :mod:`repro_torch.kernels.ref`, which
is how the tests run here.  There is no fallback: a CUDA tensor never
reaches the plain version, and a kernel that fails to build or launch
raises.  A ``meta`` tensor (the dry run, ``launch/dryrun.py``) computes
nothing: each op returns ``torch.empty`` of its results on ``meta``,
makes the same scratch tensors as the kernel's wrapper (so a memory count
sees them) and adds the kernel's FLOPs and bytes
(``launch.roofline.kernel_work``) to every count in :data:`META_COUNTS`.
Tensors on any other device are refused.  The contract of each op is
defined by kernels/ref.py.

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
from .block_attention_bwd import ROWS as _BWD_ROWS
from .block_attention_bwd import banded_attention_bwd as _banded_bwd_kernel
from .bsmm_pairs import bsmm_pairs as _bsmm_pairs_kernel

__all__ = ["LAUNCHES", "META_COUNTS", "VARIANT_LAUNCHES",
           "banded_attention", "batched_gemm", "bsmm_pairs"]

#: callables ``count(kernel, flops, nbytes)`` that a call on ``meta``
#: tensors reports its kernel's work to (the dry run's counting mode)
META_COUNTS: list = []


def _route(t: torch.Tensor) -> str:
    """``"cuda"`` (the kernel), ``"cpu"`` (the plain version) or ``"meta"``
    (the count); any other device is refused."""
    if t.device.type in ("cuda", "cpu", "meta"):
        return t.device.type
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _count_meta(kernel: str, **shape) -> None:
    """Report one meta call's kernel work to every count."""
    from repro_torch.launch.roofline import kernel_work
    flops, nbytes = kernel_work(kernel, **shape)
    for count in META_COUNTS:
        count(kernel, flops, nbytes)


def batched_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[p] = A[p] @ B[p]; (P, bs, bs) each, f32 accumulation."""
    route = _route(a)
    if route == "cuda":
        return _batched_gemm_kernel(a, b)
    if route == "meta":
        _count_meta("batched_gemm", products=a.shape[0], bs=a.shape[1],
                    itemsize=a.element_size())
        return torch.empty_like(a)
    return ref.batched_gemm_ref(a, b)


def bsmm_pairs(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
               sa: torch.Tensor, sb: torch.Tensor, seg: torch.Tensor, *,
               cap_c: int) -> torch.Tensor:
    """C[seg[p]] += A[sa[p]] @ B[sb[p]]; seg ascending, cap_c = invalid.

    Slot ids are clamped into range (invalid pairs may point anywhere;
    the kernel clamps them as it reads them), and C slots that no pair
    visits come back zero.
    """
    route = _route(a_blocks)
    if route == "cuda":
        return _bsmm_pairs_kernel(a_blocks, b_blocks, sa, sb, seg,
                                  cap_c=cap_c)
    if route == "meta":
        # which pairs are valid is data: every pair counts; the kernel's
        # run offsets (cap_c + 1 int32) are its scratch
        bs = a_blocks.shape[1]
        _count_meta("bsmm_pairs", a_blocks=a_blocks.shape[0],
                    b_blocks=b_blocks.shape[0], c_blocks=cap_c, bs=bs,
                    pairs=sa.shape[0], valid_pairs=sa.shape[0],
                    itemsize=a_blocks.element_size())
        out = torch.empty((cap_c, bs, bs), dtype=a_blocks.dtype,
                          device="meta")
        offsets = torch.empty(cap_c + 1, dtype=torch.int32,  # noqa: F841
                              device="meta")
        return out
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
    recompute the softmax; neither reads the forward's output).  On meta
    both count their kernel's work and return empty results."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        route = _route(q)
        if route == "cuda":
            out = _banded_attention_kernel(q, k, v, window=window,
                                           causal=causal)
        elif route == "meta":
            _count_meta("block_attention", **_attention_shape(q, k, window,
                                                              causal))
            out = torch.empty_like(q)
        else:
            out = ref.banded_attention_ref(q, k, v, window, causal=causal)
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        route = _route(q)
        if route == "cuda":
            dq, dk, dv = _banded_bwd_kernel(q, k, v, do.contiguous(),
                                            window=ctx.window,
                                            causal=ctx.causal)
        elif route == "meta":
            _count_meta("block_attention_bwd", **_attention_shape(
                q, k, ctx.window, ctx.causal))
            do = do.contiguous()
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            # the backward kernel's row statistics (lse and delta), alive
            # until the call returns, as the wrapper's
            rows = -(-q.shape[1] // _BWD_ROWS) * _BWD_ROWS
            stats = [torch.empty((q.shape[0], rows),  # noqa: F841
                                 dtype=torch.float32, device="meta")
                     for _ in range(2)]
        else:
            dq, dk, dv = ref.banded_attention_bwd_ref(
                q, k, v, do, ctx.window, causal=ctx.causal)
        return dq, dk, dv, None, None


def _attention_shape(q: torch.Tensor, k: torch.Tensor, window: int,
                     causal: bool) -> dict:
    h, s, d = q.shape
    return {"heads": h, "kv_heads": k.shape[0], "seq": s, "head_dim": d,
            "window": min(window, s), "causal": causal,
            "itemsize": q.element_size()}
