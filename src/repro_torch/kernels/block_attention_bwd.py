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
Two or three grids a call: dq and the row statistics, then dk and dv
(one grid in the ``fma`` design, a grid each in the ``wgmma`` design).

The source holds two designs, and this wrapper picks one per call
(:func:`design_for`):

* ``wgmma`` — bfloat16 with D a multiple of 8 and at most 128 (the LM's hd
  120 and hd 128) and 16-byte-aligned tensors.  Tensor cores for the five
  products, tiles brought in by TMA; P and dS enter their products as
  two bfloat16 parts (``hi + lo``), so that the gradients keep float32
  accuracy and are rounded once, as in the FMA design.
* ``fma`` — everything else: float32, bfloat16 with D not a multiple of 8
  or above 128.  Float32 FMA loops on tiles in shared memory.

Each call adds one to ``LAUNCHES["block_attention_bwd"]`` and one to
``VARIANT_LAUNCHES["block_attention_bwd"][design]``.

This module launches the kernel and nothing else: the dispatch between the
kernel (CUDA tensors) and the plain version (CPU tensors) lives in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .block_attention import check_launch

#: the designs of the source, as counted in ``VARIANT_LAUNCHES``
DESIGNS = ("fma", "wgmma")
#: widest head of the wgmma design (two 64-column boxes)
WGMMA_MAX_HEAD_DIM = 128
#: rows of a block of the wgmma design's grids: the lse and delta scratch
#: holds S rounded up to it a head (the fma design uses the first S)
ROWS = 128

_FN = {("fma", torch.float32): "banded_attention_bwd_f32",
       ("fma", torch.bfloat16): "banded_attention_bwd_bf16",
       ("wgmma", torch.bfloat16): "banded_attention_bwd_wgmma_bf16"}


def _entry(design: str, dtype: torch.dtype):
    fn = getattr(_build.load("block_attention_bwd"), _FN[design, dtype])
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def design_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               do: torch.Tensor | None = None) -> str:
    """The design a call with these tensors goes to: ``"wgmma"`` for
    bfloat16 with D a multiple of 8 and at most :data:`WGMMA_MAX_HEAD_DIM`
    and every base 16-byte aligned (what the tensor maps of TMA need),
    else ``"fma"``.  It depends on type, shape and alignment only."""
    ts = (q, k, v) if do is None else (q, k, v, do)
    d = q.shape[-1]
    if q.dtype == torch.bfloat16 and d % 8 == 0 and d <= WGMMA_MAX_HEAD_DIM \
            and all(t.data_ptr() % 16 == 0 for t in ts):
        return "wgmma"
    return "fma"


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
    lse = torch.empty((h, -(-s // ROWS) * ROWS), dtype=torch.float32,
                      device=q.device)
    delta = torch.empty_like(lse)
    design = design_for(q, k, v, do)
    err = _entry(design, q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), h, k.shape[0], s, d,
        min(window, s), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"banded_attention_bwd ({design})")
    _build.LAUNCHES["block_attention_bwd"] += 1
    _build.VARIANT_LAUNCHES["block_attention_bwd"][design] += 1
    return dq, dk, dv
