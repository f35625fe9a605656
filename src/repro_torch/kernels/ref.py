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
