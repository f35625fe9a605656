"""Block-sparse leaf matrix type (paper §4.1).

Faithful host-side implementation of the paper's leaf matrix library:

* uniform blocksize ``bs`` (paper targets 16-64); only nonzero ``bs x bs``
  submatrix blocks are allocated;
* multiplication is expressed as a **sum of outer products** (paper Fig 2):
  for every inner block index k, the batch of independent small GEMMs
  ``C[i,j] += A[i,k] @ B[k,j]`` is executed together — this is the structure
  the paper maps onto the cuBLAS batched-gemm API, and the structure the
  port's CUDA leaf kernels (csrc/batched_gemm.cu, csrc/bsmm_pairs.cu) run;
* symmetric operations (symmetric square, symmetric rank-k, symmetric
  multiply) operate on **upper-triangular block storage** and exploit symmetry
  to halve the multiply count (paper §3.3, Fig 9 right).

Everything is deterministic and validated against dense numpy in tests.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np


@dataclasses.dataclass
class LeafStats:
    """Work counters accumulated by leaf operations (feeds Figs 5-9)."""
    block_multiplies: int = 0
    flops: float = 0.0
    batches: int = 0

    def add(self, other: "LeafStats") -> None:
        self.block_multiplies += other.block_multiplies
        self.flops += other.flops
        self.batches += other.batches


class LeafMatrix:
    """Block-sparse matrix with uniform blocksize; dict of nonzero blocks.

    ``blocks[(i, j)]`` is the dense ``bs x bs`` block at block-row i /
    block-col j.  ``upper=True`` marks symmetric upper-triangular block
    storage: only blocks with i <= j are present and the full matrix is
    ``U + U^T - diag(U)`` with symmetric diagonal blocks.
    """

    __slots__ = ("n", "bs", "blocks", "upper", "dtype",
                 "_bnorm2", "_norm2_tot", "_trace", "_version")

    def __init__(self, n: int, bs: int, blocks: Optional[dict] = None,
                 upper: bool = False, dtype=np.float64):
        assert n % bs == 0, "leaf dimension must be divisible by blocksize"
        self.n = n
        self.bs = bs
        self.blocks: dict[tuple[int, int], np.ndarray] = blocks or {}
        self.upper = upper
        self.dtype = dtype
        # squared-Frobenius norm caches (per stored block + total), filled
        # lazily and dropped by invalidate_norms() whenever block data is
        # mutated in place (engine wave fills, deferred adds/transposes);
        # the trace cache follows the same lifecycle
        self._bnorm2: Optional[dict[tuple[int, int], float]] = None
        self._norm2_tot: Optional[float] = None
        self._trace: Optional[float] = None
        # monotone mutation counter: bumped with every cache
        # invalidation so device-resident copies of this leaf's blocks
        # (mesh engine) can detect staleness without hashing values
        self._version = 0

    # -- construction -------------------------------------------------------
    @classmethod
    def from_dense(cls, a: np.ndarray, bs: int, upper: bool = False,
                   tol: float = 0.0) -> "LeafMatrix":
        n = a.shape[0]
        assert a.shape == (n, n)
        g = n // bs
        m = cls(n, bs, upper=upper, dtype=a.dtype)
        for i in range(g):
            j0 = i if upper else 0
            for j in range(j0, g):
                blk = a[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs]
                if np.any(np.abs(blk) > tol):
                    m.blocks[(i, j)] = np.ascontiguousarray(blk)
        return m

    def to_dense(self) -> np.ndarray:
        a = np.zeros((self.n, self.n), dtype=self.dtype)
        bs = self.bs
        for (i, j), blk in self.blocks.items():
            a[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = blk
        if self.upper:
            full = a + a.T
            d = np.arange(self.n)
            # diagonal blocks were stored full & symmetric: undo the doubling
            g = self.n // bs
            for i in range(g):
                if (i, i) in self.blocks:
                    blk = self.blocks[(i, i)]
                    full[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs] = blk
            _ = d
            return full
        return a

    # -- bookkeeping ---------------------------------------------------------
    def nbytes(self) -> int:
        itemsize = np.dtype(self.dtype).itemsize
        return len(self.blocks) * self.bs * self.bs * itemsize + 32

    @property
    def grid(self) -> int:
        return self.n // self.bs

    def n_nonzero_blocks(self) -> int:
        return len(self.blocks)

    def fill_factor(self) -> float:
        return len(self.blocks) / max(1, self.grid ** 2)

    def is_zero(self) -> bool:
        return not self.blocks

    # -- norm caches (truncated multiply, DESIGN.md §5) ----------------------
    def block_norm2(self, key: tuple[int, int]) -> float:
        """Squared Frobenius norm of one stored block, cached.

        The cache is what makes SpAMM-style pruning cheap: the truncated
        multiply queries every candidate block pair, but each block is
        reduced once.
        """
        if self._bnorm2 is None:
            self._bnorm2 = {}
        v = self._bnorm2.get(key)
        if v is None:
            blk = self.blocks[key]
            v = float((blk * blk).sum())
            self._bnorm2[key] = v
        return v

    def norm2(self) -> float:
        """Squared Frobenius norm of the *stored* blocks, cached.

        For upper-triangular storage this is the norm of the stored upper
        triangle; the full symmetric norm (off-diagonal blocks counted
        twice) is assembled at the quadtree layer (qt_norm2).
        """
        if self._norm2_tot is None:
            self._norm2_tot = float(
                sum(self.block_norm2(k) for k in self.blocks))
        return self._norm2_tot

    def trace(self) -> float:
        """Trace of the leaf, cached like :meth:`norm2`.

        Only diagonal blocks contribute; for upper-triangular storage the
        diagonal blocks are stored full, so the same reduction applies.
        """
        if self._trace is None:
            self._trace = float(sum(
                np.trace(blk) for (i, j), blk in self.blocks.items()
                if i == j))
        return self._trace

    def invalidate_norms(self) -> None:
        """Drop norm/trace caches after in-place mutation of block data."""
        self._bnorm2 = None
        self._norm2_tot = None
        self._trace = None
        self._version += 1

    def frob2(self) -> float:
        return self.norm2()

    # -- structure views ------------------------------------------------------
    def cols_by_k(self) -> dict[int, list[tuple[int, np.ndarray]]]:
        """Blocks grouped by block-column (the 'k' of A in C += A[:,k] B[k,:])."""
        out: dict[int, list[tuple[int, np.ndarray]]] = {}
        for (i, j), blk in self.blocks.items():
            out.setdefault(j, []).append((i, blk))
        return out

    def rows_by_k(self) -> dict[int, list[tuple[int, np.ndarray]]]:
        out: dict[int, list[tuple[int, np.ndarray]]] = {}
        for (i, j), blk in self.blocks.items():
            out.setdefault(i, []).append((j, blk))
        return out

    def transpose(self) -> "LeafMatrix":
        assert not self.upper
        out = LeafMatrix(self.n, self.bs, dtype=self.dtype)
        for (i, j), blk in self.blocks.items():
            out.blocks[(j, i)] = np.ascontiguousarray(blk.T)
        # norms are transpose-invariant: carry the caches over (maintained,
        # not recomputed) with keys mirrored
        if self._bnorm2 is not None:
            out._bnorm2 = {(j, i): v for (i, j), v in self._bnorm2.items()}
        out._norm2_tot = self._norm2_tot
        return out

    def symmetrize_full(self) -> "LeafMatrix":
        """Expand upper-triangular storage to full block storage."""
        assert self.upper
        out = LeafMatrix(self.n, self.bs, dtype=self.dtype)
        for (i, j), blk in self.blocks.items():
            out.blocks[(i, j)] = blk
            if i != j:
                out.blocks[(j, i)] = np.ascontiguousarray(blk.T)
        return out


# ---------------------------------------------------------------------------
# Block structure allocation / unpacking — the bridge between the
# dict-of-blocks host format and the packed (P, bs, bs) arrays the batched
# kernels produce (paper §4.1: leaf data is handed to the accelerator as one
# batch; the engine gathers operands pair-wise, results come back packed).
# ---------------------------------------------------------------------------

def unpack_blocks(leaf: LeafMatrix, keys: Iterable[tuple[int, int]],
                  data: np.ndarray) -> None:
    """Fill existing blocks *in place* from a packed (P, bs, bs) array.

    In-place assignment (rather than rebinding) is what lets the engine fill
    placeholder blocks after downstream tasks already hold references.
    Norm caches computed against the zero placeholders are dropped.
    """
    for key, blk in zip(keys, data):
        leaf.blocks[key][...] = blk
    leaf.invalidate_norms()


def alloc_structure(n: int, bs: int, keys: Iterable[tuple[int, int]],
                    upper: bool = False, dtype=np.float64) -> LeafMatrix:
    """Leaf with the given block structure, all blocks zero-allocated."""
    out = LeafMatrix(n, bs, upper=upper, dtype=dtype)
    for key in keys:
        out.blocks[key] = np.zeros((bs, bs), dtype)
    return out


# ---------------------------------------------------------------------------
# Batched-GEMM schedule (Fig 2): one batch per inner block index k; all
# multiplies in a batch are independent (distinct output blocks).
# ---------------------------------------------------------------------------

def multiply_batches(a: LeafMatrix, b: LeafMatrix
                     ) -> Iterable[list[tuple[int, int, int]]]:
    """Yield, per inner index k, the batch [(i, j, k), ...] of block GEMMs."""
    a_cols = a.cols_by_k()
    b_rows = b.rows_by_k()
    for k in sorted(set(a_cols) & set(b_rows)):
        yield [(i, j, k) for i, _ in a_cols[k] for j, _ in b_rows[k]]


def leaf_multiply(a: LeafMatrix, b: LeafMatrix, ta: bool = False,
                  tb: bool = False, stats: Optional[LeafStats] = None
                  ) -> LeafMatrix:
    """C = op(A) op(B) with op in {identity, transpose} (paper §3.2).

    Executed as a sum of outer products over the inner block index: for each
    k the batch of independent block GEMMs is evaluated with one vectorised
    einsum (the host stand-in for one batched-gemm call).
    """
    assert not a.upper and not b.upper
    aa = a.transpose() if ta else a
    bb = b.transpose() if tb else b
    assert aa.n == bb.n
    out = LeafMatrix(aa.n, aa.bs, dtype=np.result_type(a.dtype, b.dtype))
    a_cols = aa.cols_by_k()
    b_rows = bb.rows_by_k()
    bs = aa.bs
    nmul = 0
    nbatch = 0
    for k in set(a_cols) & set(b_rows):
        ai, ablk = zip(*a_cols[k])
        bj, bblk = zip(*b_rows[k])
        prod = np.einsum("aik,bkj->abij", np.stack(ablk), np.stack(bblk),
                         optimize=True)
        for x, i in enumerate(ai):
            for y, j in enumerate(bj):
                cur = out.blocks.get((i, j))
                if cur is None:
                    out.blocks[(i, j)] = prod[x, y].copy()
                else:
                    cur += prod[x, y]
        nmul += len(ai) * len(bj)
        nbatch += 1
    if stats is not None:
        stats.block_multiplies += nmul
        stats.flops += 2.0 * nmul * bs ** 3
        stats.batches += nbatch
    return out


def leaf_add(a: Optional[LeafMatrix], b: Optional[LeafMatrix]
             ) -> Optional[LeafMatrix]:
    """C = A + B; either operand may be None (NIL)."""
    if a is None:
        return b
    if b is None:
        return a
    assert a.n == b.n and a.bs == b.bs and a.upper == b.upper
    out = LeafMatrix(a.n, a.bs, upper=a.upper,
                     dtype=np.result_type(a.dtype, b.dtype))
    for key, blk in a.blocks.items():
        out.blocks[key] = blk.copy()
    for key, blk in b.blocks.items():
        cur = out.blocks.get(key)
        if cur is None:
            out.blocks[key] = blk.copy()
        else:
            cur += blk
    return out


def _upper_from_full(full: LeafMatrix) -> LeafMatrix:
    out = LeafMatrix(full.n, full.bs, upper=True, dtype=full.dtype)
    for (i, j), blk in full.blocks.items():
        if i <= j:
            out.blocks[(i, j)] = blk
    return out


def leaf_sym_square(a: LeafMatrix, stats: Optional[LeafStats] = None
                    ) -> LeafMatrix:
    """C = A^2, A symmetric in upper-triangular block storage (paper §3.3).

    Exploits symmetry: only the upper triangle of C is computed.  Block pair
    (i,k),(k,j) contributes to C[i,j] with i<=j only; using A_ik = A_ki^T the
    multiply count is roughly half of the general product.
    """
    assert a.upper
    bs = a.bs
    out = LeafMatrix(a.n, bs, upper=True, dtype=a.dtype)
    full = a.symmetrize_full()  # structure view; no extra multiplies counted
    a_cols = full.cols_by_k()
    a_rows = full.rows_by_k()
    nmul = 0
    for k, col in a_cols.items():
        # C[i,j] += A[i,k] A[k,j]  for i <= j; A[k,j] = full blocks row k
        row = a_rows.get(k, [])
        for i, ablk in col:
            for j, bblk in row:
                if i > j:
                    continue  # lower triangle skipped: the symmetry saving
                cur = out.blocks.get((i, j))
                prod = ablk @ bblk
                if cur is None:
                    out.blocks[(i, j)] = prod
                else:
                    cur += prod
                nmul += 1
    if stats is not None:
        stats.block_multiplies += nmul
        stats.flops += 2.0 * nmul * bs ** 3
        stats.batches += len(a_cols)
    return out


def leaf_syrk(a: LeafMatrix, trans: bool = False,
              stats: Optional[LeafStats] = None) -> LeafMatrix:
    """C = A A^T (trans=False) or A^T A (trans=True), C upper storage."""
    assert not a.upper
    bs = a.bs
    out = LeafMatrix(a.n, bs, upper=True, dtype=a.dtype)
    # C[i,j] = sum_k A[i,k] A[j,k]^T   (or A[k,i]^T A[k,j])
    groups = a.rows_by_k() if not trans else None
    nmul = 0
    if not trans:
        rows = a.rows_by_k()
        for i in rows:
            for j in rows:
                if i > j:
                    continue
                ks = {k: blk for k, blk in rows[i]}
                for k, bjk in rows[j]:
                    if k in ks:
                        prod = ks[k] @ bjk.T
                        cur = out.blocks.get((i, j))
                        if cur is None:
                            out.blocks[(i, j)] = prod
                        else:
                            cur += prod
                        nmul += 1
    else:
        cols = a.cols_by_k()
        for i in cols:
            for j in cols:
                if i > j:
                    continue
                ks = {k: blk for k, blk in cols[i]}
                for k, bkj in cols[j]:
                    if k in ks:
                        prod = ks[k].T @ bkj
                        cur = out.blocks.get((i, j))
                        if cur is None:
                            out.blocks[(i, j)] = prod
                        else:
                            cur += prod
                        nmul += 1
    _ = groups
    if stats is not None:
        stats.block_multiplies += nmul
        stats.flops += 2.0 * nmul * bs ** 3
        stats.batches += 1
    return out


def leaf_sym_multiply(s: LeafMatrix, b: LeafMatrix, side: str = "left",
                      stats: Optional[LeafStats] = None) -> LeafMatrix:
    """C = S B (side='left') or C = B S (side='right'), S symmetric upper."""
    assert s.upper and not b.upper
    full = s.symmetrize_full()
    if side == "left":
        return leaf_multiply(full, b, stats=stats)
    return leaf_multiply(b, full, stats=stats)


def leaf_scale(a: LeafMatrix, alpha: float) -> LeafMatrix:
    out = LeafMatrix(a.n, a.bs, upper=a.upper, dtype=a.dtype)
    for key, blk in a.blocks.items():
        out.blocks[key] = alpha * blk
    return out


def inv_chol_keys(grid: int) -> list[tuple[int, int]]:
    """Deterministic block structure of a leaf inverse Cholesky factor.

    The inverse factor of a dense-diagonal SPD leaf has a full upper
    triangle in general; emitting every i <= j block (zeros included)
    regardless of the numeric values keeps the structure a function of
    the *input structure* only, so the numpy and torch engines build
    identical chunk trees (Plan fingerprints and rebinding rely on that).
    """
    return [(i, j) for i in range(grid) for j in range(i, grid)]


def tri_solve_keys(b_keys: Iterable[tuple[int, int]], grid: int
                   ) -> list[tuple[int, int]]:
    """Deterministic block structure of X = R^{-1} B, R upper triangular.

    Back substitution propagates block (k, j) of B upward into rows
    i <= k of X, so column j of X occupies rows 0..max_k(k, j in B).
    Like :func:`inv_chol_keys` this depends only on B's structure —
    identical across engines by construction.
    """
    top: dict[int, int] = {}
    for (k, j) in b_keys:
        top[j] = max(top.get(j, -1), k)
    return sorted((i, j) for j, kmax in top.items() for i in range(kmax + 1))


def leaf_inv_chol(s: LeafMatrix, stats: Optional[LeafStats] = None
                  ) -> LeafMatrix:
    """Z = inv(U) for S = U^T U: the leaf-level inverse Cholesky factor.

    ``s`` is an SPD leaf in symmetric upper block storage; the result is
    upper triangular in *plain* storage with the deterministic
    :func:`inv_chol_keys` structure (zero blocks kept — see there).
    """
    assert s.upper
    sd = s.to_dense()
    u = np.linalg.cholesky(sd).T                    # S = U^T U, U upper
    z = np.linalg.solve(u, np.eye(s.n, dtype=sd.dtype))
    bs = s.bs
    out = LeafMatrix(s.n, bs, dtype=sd.dtype)
    for (i, j) in inv_chol_keys(s.grid):
        out.blocks[(i, j)] = np.ascontiguousarray(
            z[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs])
    if stats is not None:
        stats.flops += float(s.n) ** 3              # ~n^3/3 chol + ~2n^3/3 inv
        stats.batches += 1
    return out


def leaf_tri_solve(r: LeafMatrix, b: LeafMatrix,
                   stats: Optional[LeafStats] = None) -> LeafMatrix:
    """X = R^{-1} B with R upper triangular (plain storage), leaf level.

    Output structure is the deterministic :func:`tri_solve_keys` set
    (zero blocks kept), so both engines agree block-for-block.
    """
    assert not r.upper and not b.upper and r.n == b.n and r.bs == b.bs
    rd = r.to_dense()
    bd = b.to_dense()
    x = np.linalg.solve(rd, bd)
    bs = r.bs
    out = LeafMatrix(r.n, bs, dtype=np.result_type(rd.dtype, bd.dtype))
    for (i, j) in tri_solve_keys(b.blocks, r.grid):
        out.blocks[(i, j)] = np.ascontiguousarray(
            x[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs])
    if stats is not None:
        stats.flops += float(r.n) ** 2 * b.grid * b.bs
        stats.batches += 1
    return out


def leaf_truncate(a: LeafMatrix, tau_frob: float) -> LeafMatrix:
    """Drop smallest blocks while ||dropped||_F <= tau (paper §6.2 truncation)."""
    items = sorted(a.blocks.items(), key=lambda kv: (kv[1] ** 2).sum())
    budget = tau_frob * tau_frob
    out = LeafMatrix(a.n, a.bs, upper=a.upper, dtype=a.dtype)
    acc = 0.0
    for key, blk in items:
        w = float((blk * blk).sum())
        if acc + w <= budget:
            acc += w
            continue
        out.blocks[key] = blk
    return out
