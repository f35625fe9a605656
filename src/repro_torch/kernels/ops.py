"""Public wrappers around the CUDA kernels, dispatched by device.

A CUDA tensor goes to the hand-written kernel (built at first use); a CPU
tensor goes to the plain version in :mod:`repro_torch.kernels.ref`, which
is how the tests run here.  There is no fallback: a CUDA tensor never
reaches the plain version, and a kernel that fails to build or launch
raises.  Tensors on any other device are refused.  The contract of each
op is defined by kernels/ref.py.
"""
from __future__ import annotations

import torch

from . import ref
from ._build import LAUNCHES
from .batched_gemm import batched_gemm as _batched_gemm_kernel
from .bsmm_pairs import bsmm_pairs as _bsmm_pairs_kernel

__all__ = ["LAUNCHES", "batched_gemm", "bsmm_pairs"]


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

    Slot ids are clamped into range (invalid pairs may point anywhere),
    and C slots that no pair visits come back zero.
    """
    sa = sa.clamp(0, max(a_blocks.shape[0] - 1, 0))
    sb = sb.clamp(0, max(b_blocks.shape[0] - 1, 0))
    if _on_cuda(a_blocks):
        return _bsmm_pairs_kernel(a_blocks, b_blocks, sa, sb, seg,
                                  cap_c=cap_c)
    return ref.bsmm_pairs_ref(a_blocks, b_blocks, sa, sb, seg, cap_c)
