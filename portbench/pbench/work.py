"""The yardstick's arithmetic: the H100's peaks, a product's least time,
and the shares read against them.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at
the full 700 W).  Float32 multiply work that keeps float32's error runs
on the tensor cores as three TF32 products (3xTF32), so its rate is the
TF32 rate over three.  A product's work comes from its inputs' block
masks, whatever kernel does it: 2 bs^3 operations per structural block
pair, and each participating input block read once and each C block
written once.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: HBM3 bytes/s of one H100 SXM
HBM_BPS = 3.35e12
#: dense TF32 tensor-core FLOP/s of one H100 SXM
TF32_FLOPS = 495e12
#: float32 products at float32's error: three TF32 products each
FP32_3XTF32_FLOPS = TF32_FLOPS / 3
#: bytes of one float32 element
F32_BYTES = 4


@dataclasses.dataclass
class Work:
    """One product's work: operations and bytes (float32 blocks)."""
    flops: float
    bytes: float
    pairs: int
    c_blocks: int
    input_blocks: int


def product_work(a_keys: np.ndarray, b_keys: np.ndarray, ia: np.ndarray,
                 ib: np.ndarray, c_blocks: int, bs: int,
                 symmetric: bool) -> Work:
    """The work of C = A B over the structural pairs (ia, ib).  A
    symmetric operand (A = B, stored as its upper blocks) is read once:
    its participating blocks count by their stored (upper) key."""
    if symmetric:
        keys = np.concatenate([a_keys[np.unique(ia)], b_keys[np.unique(ib)]])
        keys = np.sort(keys, axis=1)        # (I, K) and (K, I) are one block
        n_in = len(np.unique(keys, axis=0))
    else:
        n_in = len(np.unique(ia)) + len(np.unique(ib))
    blk = bs * bs * F32_BYTES
    return Work(flops=2.0 * bs ** 3 * len(ia),
                bytes=float((n_in + c_blocks) * blk), pairs=len(ia),
                c_blocks=c_blocks, input_blocks=n_in)


def least_s(work: Work, chips: int = 1) -> tuple[float, str]:
    """The least time of the work spread over ``chips`` cards, and which
    bound sets it (``bytes`` or ``operations``)."""
    tb = work.bytes / (HBM_BPS * chips)
    tf = work.flops / (FP32_3XTF32_FLOPS * chips)
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def roofline_pct(run, names) -> float | None:
    """Per cent of the product's least time on ``run.chips`` cards that
    the kernels named ``names`` reach: the least time over their device
    time per product, averaged over the chips.  None where the trace holds
    no such kernel."""
    if not run.traces:
        return None
    per_chip = sum(t.kernel_s(names) for t in run.traces) / len(run.traces)
    if per_chip <= 0:
        return None
    return 100.0 * least_s(run.work, run.chips)[0] / (per_chip / run.products)
