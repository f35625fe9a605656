"""CUDA kernel: the backward of banded (sliding-window) attention
(``csrc/block_attention_bwd.cu``).

The gradient of :func:`repro_torch.kernels.block_attention.banded_attention`
for training.  The JAX package has no Pallas backward; it trains through
XLA's autodiff of ``src/repro/models/layers.py::windowed_attention``, and
this kernel is the port's counterpart of that gradient.  Given q (H, S, D),
k, v (H_kv, S, D) and the output gradient do, it returns dq (H, S, D) and
dk, dv (H_kv, S, D) in q's type, each kv head's gradient summed over its
H / H_kv query heads, with the forward's band mask and float32 sums.  It
recomputes what it needs from q, k and v (the softmax's row statistics and
``rowsum(do * o)`` in float32), so it does not read the forward's output.
Two grids (dq and the row statistics, then dk and dv); each call adds one
to ``LAUNCHES["block_attention_bwd"]``.

This module launches the kernel and nothing else: the dispatch between the
kernel (CUDA tensors) and the plain version (CPU tensors) lives in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .block_attention import check_launch

_FN = {torch.float32: "banded_attention_bwd_f32",
       torch.bfloat16: "banded_attention_bwd_bf16"}


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("block_attention_bwd"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def banded_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, *, window: int,
                         causal: bool = True) -> tuple:
    """``(dq, dk, dv)`` of :func:`banded_attention` at ``(q, k, v)`` for the
    output gradient ``do``.

    q, do  : (H, S, D); k, v : (H_kv, S, D) with H_kv dividing H; float32 or
             bfloat16 of one type, CUDA, contiguous; H <= 65535, D even and
             <= 256
    window : >= 1 key positions to each side, self included
    """
    check_launch("banded_attention_bwd", q, k, v, window, like_q=(do,))
    h, s, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if h == 0 or s == 0:
        return dq, dk, dv
    lse = torch.empty((h, s), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    err = _entry(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), h, k.shape[0], s, d,
        min(window, s), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "banded_attention_bwd")
    _build.LAUNCHES["block_attention_bwd"] += 1
    return dq, dk, dv
