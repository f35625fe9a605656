"""CUDA kernel: gather-GEMM-scatter over block pairs (``csrc/bsmm_pairs.cu``).

The Hopper port of ``src/repro/kernels/bsmm_pairs.py::bsmm_pairs``: for
every pair p, ``C[seg[p]] += A[sa[p]] @ B[sb[p]]``, with ``seg`` ascending
and ``seg == cap_c`` marking a dropped pair.  A persistent grid of teams
(one warp, four at bs 64): team t of T takes the slots t, t + T, ... and
streams their pairs through its own ``cp.async`` ring; a team sums a
slot's run in the order the engine fixed, without atomics, so a slot's
value depends on its run alone.  A slot that no pair visits comes back
zero.  The run offsets are found on the device by a small kernel of the
same source.

The source holds two designs, and :func:`design_for` picks one per call:

* ``mma`` — bs 16, 32 and 64: tensor cores (``mma.sync``).  float32 as
  3xTF32 (``a_hi b_hi + a_hi b_lo + a_lo b_hi``, each part truncated to
  TF32), which keeps about float32's error; bfloat16 products exact in
  float32.
* ``fma`` — bs 4 and 8: float32 FMA, one or two outputs a lane.

Each launch adds one to ``LAUNCHES["bsmm_pairs"]`` and one to
``VARIANT_LAUNCHES["bsmm_pairs"][design]``.

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

#: designs of the source, by the number the C entry points take
DESIGNS = ("fma", "mma")

_FN = {torch.float32: "bsmm_pairs_f32", torch.bfloat16: "bsmm_pairs_bf16"}


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("bsmm_pairs"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def design_for(a_blocks: torch.Tensor) -> str:
    """The design a call with these blocks goes to: ``"mma"`` (tensor
    cores) for bs >= 16, whose blocks fill whole m16n8 tiles, else
    ``"fma"``."""
    return "mma" if a_blocks.shape[1] >= 16 else "fma"


def bsmm_pairs(a_blocks: torch.Tensor, b_blocks: torch.Tensor,
               sa: torch.Tensor, sb: torch.Tensor, seg: torch.Tensor, *,
               cap_c: int) -> torch.Tensor:
    """``(cap_c, bs, bs)`` accumulated C blocks in ``a_blocks.dtype``.

    a_blocks : (capA, bs, bs) float32 or bfloat16, CUDA, contiguous
    b_blocks : (capB, bs, bs) same type and device
    sa, sb   : (P,) int32 slot ids; the kernel clamps them into range
    seg      : (P,) int32 output slot per pair, ascending; cap_c drops
    """
    dev = a_blocks.device
    if dev.type != "cuda":
        raise ValueError(f"bsmm_pairs kernel needs CUDA tensors, got {dev}")
    if a_blocks.dtype not in _FN or b_blocks.dtype != a_blocks.dtype:
        raise TypeError(f"bsmm_pairs takes float32 or bfloat16 blocks of one "
                        f"type, got {a_blocks.dtype} and {b_blocks.dtype}")
    if a_blocks.dim() != 3 or b_blocks.dim() != 3:
        raise ValueError("bsmm_pairs takes (cap, bs, bs) block stacks")
    bs = a_blocks.shape[1]
    if bs not in BLOCK_SIZES or a_blocks.shape[2] != bs \
            or b_blocks.shape[1:] != a_blocks.shape[1:]:
        raise ValueError(f"bsmm_pairs takes square bs x bs blocks with bs in "
                         f"{BLOCK_SIZES}, got {tuple(a_blocks.shape)} and "
                         f"{tuple(b_blocks.shape)}")
    n_pairs = sa.shape[0]
    for name, t in (("sa", sa), ("sb", sb), ("seg", seg)):
        if t.dtype != torch.int32 or t.shape != (n_pairs,):
            raise TypeError(f"bsmm_pairs: {name} must be ({n_pairs},) int32, "
                            f"got {tuple(t.shape)} {t.dtype}")
    for t in (b_blocks, sa, sb, seg):
        if t.device != dev:
            raise ValueError(f"bsmm_pairs: operands on {t.device} and {dev}")
    for t in (a_blocks, b_blocks, sa, sb, seg):
        if not t.is_contiguous():
            raise ValueError("bsmm_pairs takes contiguous tensors")
    if n_pairs and (a_blocks.shape[0] == 0 or b_blocks.shape[0] == 0):
        raise ValueError("bsmm_pairs: pairs given but no blocks to gather")
    if n_pairs >= 2 ** 31:
        raise ValueError("bsmm_pairs: more than 2**31 - 1 pairs")

    out = torch.empty((cap_c, bs, bs), dtype=a_blocks.dtype, device=dev)
    if cap_c == 0:
        return out
    # the kernel moves 16-byte chunks: a view that starts off that grid is
    # copied to a fresh (aligned) allocation first
    a_blocks, b_blocks = (t if t.data_ptr() % 16 == 0 else t.clone()
                          for t in (a_blocks, b_blocks))
    # run of slot s is [offsets[s], offsets[s + 1]), filled by the kernel;
    # pairs with seg == cap_c lie past offsets[cap_c] and are never read
    offsets = torch.empty(cap_c + 1, dtype=torch.int32, device=dev)
    design = design_for(a_blocks)
    err = _entry(a_blocks.dtype)(
        a_blocks.data_ptr(), b_blocks.data_ptr(), sa.data_ptr(),
        sb.data_ptr(), seg.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        a_blocks.shape[0], b_blocks.shape[0], n_pairs, cap_c, bs,
        DESIGNS.index(design), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"bsmm_pairs ({design})")
    _build.LAUNCHES["bsmm_pairs"] += 1
    _build.VARIANT_LAUNCHES["bsmm_pairs"][design] += 1
    return out
