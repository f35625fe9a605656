"""CUDA kernel: banded (sliding-window) flash attention
(``csrc/block_attention.cu``).

The Hopper port of ``src/repro/kernels/block_attention.py::banded_attention``:
q, k, v of shape (H, S, D) -> (H, S, D), where query i attends key j iff
``|i - j| < window`` (and ``j <= i`` when causal), with a float32 online
softmax and the output ``acc / (l + 1e-30)`` in q's type.  One thread block
owns one (head, 64-query tile) and walks the kv tiles of the band once each.

This module launches the kernel and nothing else: the dispatch between the
kernel (CUDA tensors) and the plain version (CPU tensors), and the checks
of the reference's block contract, live in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: widest head the kernel is instantiated for
MAX_HEAD_DIM = 256

_FN = {torch.float32: "banded_attention_f32",
       torch.bfloat16: "banded_attention_bf16"}


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("block_attention"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, causal: bool = True) -> torch.Tensor:
    """``(H, S, D)`` sliding-window attention in ``q.dtype``.

    q, k, v : (H, S, D) float32 or bfloat16 of one type, CUDA, contiguous;
              H <= 65535, D even and <= 256
    window  : >= 1 key positions to each side, self included
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"banded_attention kernel needs CUDA tensors, "
                         f"got {dev}")
    if q.dtype not in _FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"banded_attention takes float32 or bfloat16 q, k, v "
                        f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"banded_attention takes (H, S, D) q, k, v of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    h, s, d = q.shape
    if h > 65535 or d % 2 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"banded_attention kernel takes H <= 65535 and an "
                         f"even D <= {MAX_HEAD_DIM}, got H={h} D={d}")
    if s >= 2 ** 31:
        raise ValueError("banded_attention: sequence too long")
    if window < 1:
        raise ValueError(f"banded_attention: window must be >= 1, got "
                         f"{window}")
    for t in (k, v):
        if t.device != dev:
            raise ValueError(f"banded_attention: operands on {t.device} and "
                             f"{dev}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("banded_attention takes contiguous tensors")

    out = torch.empty_like(q)
    if h == 0 or s == 0:
        return out
    err = _entry(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), h, s, d,
        min(window, s), int(causal),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "banded_attention")
    _build.LAUNCHES["block_attention"] += 1
    return out
