"""Gradient compression for the data-parallel reduction (the port of
``repro/runtime/compression.py``).

Per-tensor symmetric int8 quantization: 4x fewer bytes on the DP wire for
<1% relative error on typical gradient distributions.  On a real pod the
reduction becomes quantize -> reduce-scatter (int8 -> float32 accumulate in
two phases) -> dequantize; here the quantize/dequantize pair (unit tested
for its error bound) plus ``compressed_grad_tree``, which rewrites a
gradient tree through the wire format.  The compression is lossy and
unbiased per tensor (scale = max|g| / 127).
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale float32); scale is per-tensor max-abs / 127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_grad_tree(grads):
    """Round-trip every leaf of a nested dict through the int8 wire format
    (what the DP reduction would transmit)."""
    if isinstance(grads, dict):
        return {k: compressed_grad_tree(g) for k, g in grads.items()}
    q, s = quantize_int8(grads)
    return dequantize_int8(q, s, grads.dtype)
