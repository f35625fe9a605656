"""CUDA kernel: batched small GEMM (``csrc/batched_gemm.cu``).

The Hopper port of ``src/repro/kernels/batched_gemm.py::batched_gemm``:
``C[p] = A[p] @ B[p]`` over a ``(P, bs, bs)`` stack, float32 sums, output
in A's type.  The TPU kernel padded P to a multiple of its batch tile; this
one masks its ragged last thread block instead, so it takes any P.

This module launches the kernel and nothing else: the dispatch between the
kernel (CUDA tensors) and the plain version (CPU tensors) lives in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: block sizes the kernel is instantiated for
BLOCK_SIZES = (4, 8, 16, 32, 64)

_FN = {torch.float32: "batched_gemm_f32", torch.bfloat16: "batched_gemm_bf16"}


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("batched_gemm"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def batched_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(P, bs, bs) @ (P, bs, bs)`` per product, in ``a.dtype``.

    ``a`` and ``b`` are float32 or bfloat16 CUDA tensors of one type and
    shape, contiguous.  ``P == 0`` returns an empty stack.
    """
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"batched_gemm kernel needs CUDA tensors, got {dev}")
    if b.device != dev:
        raise ValueError(f"batched_gemm: operands on {b.device} and {dev}")
    if a.dtype not in _FN or b.dtype != a.dtype:
        raise TypeError(f"batched_gemm takes float32 or bfloat16 stacks of "
                        f"one type, got {a.dtype} and {b.dtype}")
    if a.dim() != 3 or a.shape != b.shape or a.shape[1] != a.shape[2] \
            or a.shape[1] not in BLOCK_SIZES:
        raise ValueError(f"batched_gemm takes two (P, bs, bs) stacks with bs "
                         f"in {BLOCK_SIZES}, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("batched_gemm takes contiguous tensors")
    p, bs, _ = a.shape
    if p >= 2 ** 31:
        raise ValueError("batched_gemm: more than 2**31 - 1 products")
    out = torch.empty_like(a)
    if p == 0:
        return out
    err = _entry(a.dtype)(a.data_ptr(), b.data_ptr(), out.data_ptr(), p, bs,
                          torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "batched_gemm")
    _build.LAUNCHES["batched_gemm"] += 1
    return out
