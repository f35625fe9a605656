"""The plain reference product and the comparison that decides ``correct``.

It works from the coordinates and values the harness handed to the
program, in float64, and works out the product's block structure itself:
C = A B over ``bs x bs`` blocks, every pair (I, K) x (K, J) of nonzero
blocks, and for a symmetric product only the blocks with I <= J (the
program's upper storage).  Beside C it keeps |A| |B|, the scale of each
element's rounding error, so that an element's error reads against what
the float32 sums it came from can hold.  A product that leaves out some
of those pairs (a truncated multiply) says which it keeps through its
operator's ``reference_pairs`` (:mod:`pbench.bench`); C's structure and
|A| |B| are then those of the pairs kept.  It imports nothing of the
program and uses plain PyTorch: on the card in blocks of pairs, on the
host the same code.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: pairs multiplied per batch (bounds the reference's device memory)
PAIR_CHUNK = 1 << 15
#: blocks compared per batch
BLOCK_CHUNK = 1 << 14


@dataclasses.dataclass
class BlockMatrix:
    """Nonzero ``bs x bs`` blocks: keys (I, J) sorted row-major, and the
    blocks' float64 values, (nb, bs, bs)."""
    keys: np.ndarray
    blocks: np.ndarray
    bs: int


def block_matrix(rows, cols, vals, n: int, bs: int) -> BlockMatrix:
    """Blocks of the COO matrix (rows, cols, vals); no entry repeats."""
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    g = n // bs
    lin = (rows // bs) * g + cols // bs
    uniq, inv = np.unique(lin, return_inverse=True)
    blocks = np.zeros((len(uniq), bs, bs))
    blocks[inv, rows % bs, cols % bs] = vals
    return BlockMatrix(np.stack([uniq // g, uniq % g], 1), blocks, bs)


def block_pairs(a_keys: np.ndarray, b_keys: np.ndarray, upper: bool):
    """Every structural pair of C = A B: indices into A's and B's blocks,
    the C block each adds to, and C's keys (row-major).  ``upper`` keeps
    the pairs of C blocks with I <= J."""
    kb = b_keys[:, 0]
    order = np.argsort(kb, kind="stable")
    g = int(max(a_keys.max(initial=0), b_keys.max(initial=0))) + 1
    start = np.searchsorted(kb[order], np.arange(g + 1))
    k_of_a = a_keys[:, 1]
    cnt = start[k_of_a + 1] - start[k_of_a]
    total = int(cnt.sum())
    ia = np.repeat(np.arange(len(a_keys)), cnt)
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    ib = order[np.repeat(start[k_of_a], cnt) + np.arange(total) - first]
    ci, cj = a_keys[ia, 0], b_keys[ib, 1]
    if upper:
        keep = ci <= cj
        ia, ib, ci, cj = ia[keep], ib[keep], ci[keep], cj[keep]
    lin = ci * g + cj
    uniq, ic = np.unique(lin, return_inverse=True)
    return ia, ib, ic, np.stack([uniq // g, uniq % g], 1)


@dataclasses.dataclass
class Product:
    """The reference's C: keys, values and |A| |B| (float64, on
    ``device``), the pairs it multiplied (indices into A's and B's
    blocks) and their count."""
    keys: np.ndarray
    c: torch.Tensor
    scale: torch.Tensor
    pairs: int
    ia: np.ndarray
    ib: np.ndarray


def reference_product(a: BlockMatrix, b: BlockMatrix, upper: bool,
                      device="cpu", precision: str = "float64",
                      keep=None) -> Product:
    """C = A B in float64 (``precision="float64"``), ``"float32"``, or, as
    the control, in TF32: the operands rounded to TF32 (what the tensor
    cores do to them), their products summed in float32.  The rounding is
    explicit: cuBLAS is free to run a float32 product of 32 x 32 blocks
    without the tensor cores even where TF32 is allowed.

    ``keep(ia, ib)``, where given, is a boolean mask over the structural
    pairs: only the pairs it keeps are multiplied, and C holds the blocks
    that a kept pair adds to."""
    ia, ib, ic, keys = block_pairs(a.keys, b.keys, upper)
    if keep is not None:
        m = np.asarray(keep(ia, ib), bool)
        ia, ib = ia[m], ib[m]
        used, ic = np.unique(ic[m], return_inverse=True)
        keys = keys[used]
    dtype = torch.float64 if precision == "float64" else torch.float32
    da = torch.from_numpy(a.blocks).to(device, dtype)
    db = torch.from_numpy(b.blocks).to(device, dtype)
    if precision == "tf32":
        da, db = tf32_round(da), tf32_round(db)
    bs = a.bs
    c = torch.zeros((len(keys), bs, bs), dtype=torch.float64, device=device)
    scale = torch.zeros_like(c)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for lo in range(0, len(ia), PAIR_CHUNK):
            sl = slice(lo, lo + PAIR_CHUNK)
            xa = da[torch.from_numpy(ia[sl]).to(device)]
            xb = db[torch.from_numpy(ib[sl]).to(device)]
            seg = torch.from_numpy(ic[sl]).to(device)
            c.index_add_(0, seg, torch.bmm(xa, xb).double())
            if precision == "float64":
                scale.index_add_(0, seg, torch.bmm(xa.abs(), xb.abs()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return Product(keys, c, scale, len(ia), ia, ib)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def compare(got: dict, want: Product) -> dict:
    """Judge a product C by the reference.

    ``got`` maps each stored block (I, J) of C to its values.  Returns
    ``c_blocks_wrong``: stored blocks missing from or extra to the
    reference's structure (the limit is 0), and ``max_rel_err``: the
    largest |C - C_ref| over (|A| |B|) of any element of the blocks both
    hold (an element whose scale is 0 and whose error is not, or whose
    value is not a number, reads 1e30).
    """
    want_keys = {(int(i), int(j)): t for t, (i, j) in enumerate(want.keys)}
    wrong = len(set(got) ^ set(want_keys))
    both = [k for k in want_keys if k in got]
    worst = 0.0
    dev = want.c.device
    for lo in range(0, len(both), BLOCK_CHUNK):
        ks = both[lo:lo + BLOCK_CHUNK]
        idx = torch.tensor([want_keys[k] for k in ks], device=dev)
        g = torch.from_numpy(np.stack([np.asarray(got[k]) for k in ks])
                             ).to(dev, torch.float64)
        err = (g - want.c[idx]).abs()
        sc = want.scale[idx]
        big = torch.full_like(err, 1e30)
        rel = torch.where(sc > 0, err / torch.where(sc > 0, sc, 1.0),
                          torch.where(err == 0, 0.0, big))
        worst = max(worst, float(torch.where(rel.isnan(), big, rel).max()))
    return {"c_blocks_wrong": wrong, "max_rel_err": worst}


def as_blocks(p: Product) -> dict:
    """A reference product as ``compare`` takes a program's: (I, J) ->
    the block's values on the host."""
    c = p.c.cpu().numpy()
    return {(int(i), int(j)): c[t] for t, (i, j) in enumerate(p.keys)}
