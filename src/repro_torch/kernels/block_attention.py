"""CUDA kernel: banded (sliding-window) flash attention
(``csrc/block_attention.cu``).

The Hopper port of ``src/repro/kernels/block_attention.py::banded_attention``:
q of shape (H, S, D), k and v of shape (H_kv, S, D) with H_kv dividing H
(query head h reads kv head ``h // (H // H_kv)``) -> (H, S, D), where query
i attends key j iff ``|i - j| < window`` (and ``j <= i`` when causal), with
a float32 online softmax and the output ``acc / (l + 1e-30)`` in q's type.

The source holds two designs, and this wrapper picks one per call:

* ``wgmma`` — bfloat16 with D a multiple of 8 (every dense config: hd 120,
  128, 160) and 16-byte-aligned tensors.  Tensor cores (``wgmma``) for
  ``q kᵀ`` and ``p v``, tiles brought in by TMA, k and v read once per
  block for its 128 query rows.  p is split into two bfloat16 parts
  (``p_hi + p_lo``) for ``p v`` so that the product keeps float32
  accuracy and the output is rounded once, as in the float32 FMA design.
* ``fma`` — everything else the contract allows: float32 (whose atol 1e-4
  tensor cores cannot meet without 3xTF32) and bfloat16 with D not a
  multiple of 8.  Float32 FMA loops, one block per (head, 64 query rows).

Each launch adds one to ``LAUNCHES["block_attention"]`` and one to
``VARIANT_LAUNCHES["block_attention"][design]``.

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

_FN = {("fma", torch.float32): "banded_attention_f32",
       ("fma", torch.bfloat16): "banded_attention_bf16",
       ("wgmma", torch.bfloat16): "banded_attention_wgmma_bf16"}


def _entry(design: str, dtype: torch.dtype):
    fn = getattr(_build.load("block_attention"), _FN[design, dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q is (H, S, D) and k, v are (H_kv, S, D) with H_kv
    dividing H (H_kv = 0 only with H = 0)."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape \
            or k.shape[1:] != q.shape[1:] \
            or (q.shape[0] % k.shape[0] if k.shape[0] else q.shape[0]):
        raise ValueError(f"banded_attention takes q (H, S, D) and k, v "
                         f"(H_kv, S, D) with H_kv dividing H, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def design_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The design a call with these tensors goes to: ``"wgmma"`` for
    bfloat16 with D a multiple of 8 and every base 16-byte aligned (what
    the tensor maps of TMA need), else ``"fma"``."""
    if q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (q, k, v)):
        return "wgmma"
    return "fma"


def check_launch(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, window: int, like_q=()) -> None:
    """Raise unless the operands are what the attention kernels take: q
    (and each tensor of ``like_q``) (H, S, D), k, v (H_kv, S, D) with H_kv
    dividing H; float32 or bfloat16 of one type, on one CUDA device,
    contiguous; H <= 65535, D even and <= 256, S < 2**31; window >= 1."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {dev}")
    ts = (q, k, v, *like_q)
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{name} takes float32 or bfloat16 tensors of one "
                        f"type, got {[str(t.dtype) for t in ts]}")
    check_heads(q, k, v)
    for t in like_q:
        if t.shape != q.shape:
            raise ValueError(f"{name}: {tuple(t.shape)} is not q's shape "
                             f"{tuple(q.shape)}")
    h, s, d = q.shape
    if h > 65535 or d % 2 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"{name} kernel takes H <= 65535 and an even "
                         f"D <= {MAX_HEAD_DIM}, got H={h} D={d}")
    if s >= 2 ** 31:
        raise ValueError(f"{name}: sequence too long")
    if window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, causal: bool = True) -> torch.Tensor:
    """``(H, S, D)`` sliding-window attention in ``q.dtype``.

    q       : (H, S, D); k, v : (H_kv, S, D) with H_kv dividing H; float32
              or bfloat16 of one type, CUDA, contiguous; H <= 65535, D even
              and <= 256
    window  : >= 1 key positions to each side, self included
    """
    check_launch("banded_attention", q, k, v, window)
    h, s, d = q.shape
    out = torch.empty_like(q)
    if h == 0 or s == 0:
        return out
    design = design_for(q, k, v)
    err = _entry(design, q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), h,
        k.shape[0], s, d, min(window, s), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"banded_attention ({design})")
    _build.LAUNCHES["block_attention"] += 1
    _build.VARIANT_LAUNCHES["block_attention"][design] += 1
    return out
