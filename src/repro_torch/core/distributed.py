"""Locality-aware distributed block-sparse matmul on a torch.distributed group.

The port of ``repro/core/distributed.py``, the rendering of the paper's
central claim (Table 1): if data and work placement *follow the quadtree*,
matrices whose sparsity has spatial locality (banded, overlap) need only
**O(1) communication per device in weak scaling**, vs O(sqrt(p)) for
SUMMA-style static schedules.

Mapping (DESIGN.md §3):

* paper: chunk placement follows work-stealing over the recursive task tree
  -> here: each rank owns a contiguous **Morton range** of leaf blocks —
  exactly the leaf sets of quadtree subtrees, so "placement follows the
  recursion" holds statically;
* paper: runtime fetches remote chunks on demand, chunk cache amortizes
  -> here: a **bounded halo exchange**: ``halo_hops`` ring shifts in each
  direction collect every remote block a rank can possibly need.
  ``halo_hops`` is computed from the actual block masks at plan time
  (sparsity detected from data, not assumed) and is O(1) for banded /
  overlap patterns regardless of p;
* paper: NIL pruning at every level (Algorithm 1 line 2)
  -> here: per-rank hierarchical pair enumeration constrained to the
  rank's owned C cells (mask_c pyramid).

The host planning (owners, capacities, halo distance, demand tables) is
the reference's numpy, copied as it is.  The multiplies are per-rank
functions: the reference runs one SPMD body under ``shard_map`` with
``ppermute``; here every rank of a group calls the function with its own
shard, and a ring shift by ``s`` is a counted ``batch_isend_irecv`` (rank
r sends to (r + s) mod p and receives from (r - s) mod p).  On an NCCL
group the tensors move on the rank's CUDA device; on a gloo group they
are staged through the host and the multiply still runs on the shard's
device.  Without an initialised process group and with no mesh the
functions run as a world of one and make no collective call.  The
reference's ``make_halo_spmm`` / ``make_demand_spmm`` (jit closures for
HLO lowering) have no counterpart.

Counted bytes (``comm``) follow the reference's HLO convention
(``launch/roofline.py``): the bytes each rank *receives* per shift, every
shipped array (blocks, rows, cols) included.

The SUMMA baseline to compare against lives in core/spsumma.py.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import morton
from .blocksparse import (_np_pyramid, enumerate_pairs_hier, nonzero_padded,
                          slot_map)


# ---------------------------------------------------------------------------
# Host-side planning: ownership, capacities, halo distance
# ---------------------------------------------------------------------------

def _balanced_owner(lin: np.ndarray, cells: int, n_dev: int) -> np.ndarray:
    """Linear cell index -> device id; balanced contiguous split.

    Device ``d`` owns cells ``[d*cells//n_dev, (d+1)*cells//n_dev)`` — sizes
    differ by at most one, every id is ``< n_dev``, and when ``n_dev``
    divides ``cells`` this reduces to the classic ``lin // per``.  Handles
    ``cells % n_dev != 0`` (the old ``lin // per`` emitted ids >= n_dev)
    and ``n_dev > cells`` (the old code divided by zero).
    """
    # closed form of the split: owner(z) = d iff
    # d*cells//n_dev <= z < (d+1)*cells//n_dev.  The traced _owned_mask
    # uses the same expression — keep them in lockstep.
    return (((lin.astype(np.int64) + 1) * n_dev - 1) // cells
            ).astype(np.int32)


def morton_owner(grid: int, n_dev: int) -> np.ndarray:
    """(grid, grid) -> device id; contiguous Morton ranges."""
    rows = np.repeat(np.arange(grid), grid)
    cols = np.tile(np.arange(grid), grid)
    z = morton.encode(rows, cols).astype(np.int64)
    return _balanced_owner(z, grid * grid, n_dev).reshape(grid, grid)


def rowmajor_owner(grid: int, n_dev: int) -> np.ndarray:
    """Non-locality-aware baseline ownership: row-major block ranges."""
    lin = np.arange(grid * grid, dtype=np.int64).reshape(grid, grid)
    return _balanced_owner(lin, grid * grid, n_dev)


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """Static plan for one distributed multiply (trace-time constants)."""
    grid: int
    bs: int
    n_dev: int
    cap_d: int            # owned-block capacity per device (A and B)
    cap_c_d: int          # owned-C-block capacity per device
    halo_hops: int        # ring hops each direction
    pair_caps: tuple      # per-level pair capacities (per device)

    @property
    def halo_cap(self) -> int:
        return (2 * self.halo_hops + 1) * self.cap_d


def plan_distribution(mask_a: np.ndarray, mask_b: np.ndarray, bs: int,
                      n_dev: int, slack: float = 1.3,
                      round_to: int = 8) -> DistPlan:
    """Inspect actual block occupancy (dynamic detection, paper abstract)
    and derive all static capacities + the halo distance."""
    grid = mask_a.shape[0]
    owner = morton_owner(grid, n_dev)
    ma, mb = np.asarray(mask_a), np.asarray(mask_b)
    mc = (ma.astype(np.int64) @ mb.astype(np.int64)) > 0

    def _cap(x):
        return max(round_to,
                   int(np.ceil(x * slack / round_to)) * round_to)

    cap_d = _cap(max(np.bincount(owner[ma].ravel(), minlength=n_dev).max(),
                     np.bincount(owner[mb].ravel(), minlength=n_dev).max()))
    cap_c_d = _cap(np.bincount(owner[mc].ravel(), minlength=n_dev).max())

    # halo distance: max |owner(A[i,k]) - owner(C[i,j])| over contributing
    # pairs, same for B — measured on the coarsest level where it is cheap
    # and exact at leaf level via per-device row/col reach.
    hops = 1
    ii, kk = np.nonzero(ma)
    kk2, jj = np.nonzero(mb)
    # for each k, owners of A blocks in col k and B blocks in row k must
    # reach owners of C blocks (i, j); bound via per-cell owner differences
    oa = owner[ii, kk]
    ob = owner[kk2, jj]
    # C owners that need each A block: owners of row i of C
    ci, cj = np.nonzero(mc)
    oc = owner[ci, cj]
    row_min = np.full(grid, n_dev, np.int64)
    row_max = np.full(grid, -1, np.int64)
    np.minimum.at(row_min, ci, oc)
    np.maximum.at(row_max, ci, oc)
    col_min = np.full(grid, n_dev, np.int64)
    col_max = np.full(grid, -1, np.int64)
    np.minimum.at(col_min, cj, oc)
    np.maximum.at(col_max, cj, oc)
    ha = np.maximum(np.abs(row_max[ii] - oa), np.abs(oa - row_min[ii]))
    hb = np.maximum(np.abs(col_max[jj] - ob), np.abs(ob - col_min[jj]))
    if len(ha):
        hops = max(hops, int(ha.max()))
    if len(hb):
        hops = max(hops, int(hb.max()))
    hops = min(hops, n_dev // 2 if n_dev > 1 else 0)

    # per-level pair caps: max over devices of constrained triple counts.
    # vectorized & exact: P = A_l @ B_l counts triples per coarse C cell;
    # a coarse Morton cell covers a CONTIGUOUS device range [lo, hi] (its
    # fine cells are one Morton interval), and hierarchical enumeration
    # charges the whole cell to every device in that range -> range-add
    # via a difference array.
    levels = int(np.log2(grid))
    pyr_a, pyr_b = _np_pyramid(ma), _np_pyramid(mb)
    cells = grid * grid
    pair_caps = []
    for l in range(1, levels + 1):
        a_l = pyr_a[levels - l].astype(np.float64)
        b_l = pyr_b[levels - l].astype(np.float64)
        gl = a_l.shape[0]
        factor = grid // gl
        prod = a_l @ b_l                         # triples per C cell
        ci, cj = np.nonzero(prod > 0)
        vals = prod[ci, cj]
        z = morton.encode(ci, cj).astype(np.int64)
        # owners of the coarse cell's first/last fine Morton cell under the
        # balanced clipped split (consistent with morton_owner/_owned_mask)
        lo = ((z * factor * factor + 1) * n_dev - 1) // cells
        hi = (((z + 1) * factor * factor) * n_dev - 1) // cells
        diff = np.zeros(n_dev + 1, np.float64)
        np.add.at(diff, lo, vals)
        np.add.at(diff, np.minimum(hi + 1, n_dev), -vals)
        counts = np.cumsum(diff)[:n_dev]
        pair_caps.append(_cap(max(int(counts.max()), 8)))
    return DistPlan(grid=grid, bs=bs, n_dev=n_dev, cap_d=cap_d,
                    cap_c_d=cap_c_d, halo_hops=hops,
                    pair_caps=tuple(pair_caps))


def _coarsen_bool(m: np.ndarray, factor: int) -> np.ndarray:
    if factor == 1:
        return m
    g = m.shape[0] // factor
    return m.reshape(g, factor, g, factor).any(axis=(1, 3))


def distribute_morton(dense: np.ndarray, bs: int, plan: DistPlan,
                      owner_map: Optional[np.ndarray] = None
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a dense matrix into per-device Morton-owned block arrays.

    Returns (blocks, rows, cols): (n_dev, cap_d, bs, bs), (n_dev, cap_d)x2,
    padding coordinates == grid.  Host-side numpy (input construction is a
    data-pipeline job; the paper does it with Chunks and Tasks programs).
    """
    grid, n_dev, cap = plan.grid, plan.n_dev, plan.cap_d
    owner = morton_owner(grid, n_dev) if owner_map is None else owner_map
    tiles = dense.reshape(grid, bs, grid, bs).transpose(0, 2, 1, 3)
    occ = np.abs(tiles).max(axis=(2, 3)) > 0
    blocks = np.zeros((n_dev, cap, bs, bs), dense.dtype)
    rows = np.full((n_dev, cap), grid, np.int32)
    cols = np.full((n_dev, cap), grid, np.int32)
    fill = np.zeros(n_dev, np.int64)
    ii, jj = np.nonzero(occ)
    for i, j in zip(ii, jj):
        d = owner[i, j]
        s = fill[d]
        assert s < cap, f"device {d} overflow (cap {cap})"
        blocks[d, s] = tiles[i, j]
        rows[d, s] = i
        cols[d, s] = j
        fill[d] += 1
    return blocks, rows, cols


def gather_dense(blocks: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                 grid: int, bs: int) -> np.ndarray:
    """Inverse of distribute_morton (testing convenience)."""
    out = np.zeros((grid * bs, grid * bs), blocks.dtype)
    n_dev, cap = rows.shape
    for d in range(n_dev):
        for s in range(cap):
            i, j = rows[d, s], cols[d, s]
            if i < grid:
                out[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] += \
                    blocks[d, s]
    return out


# ---------------------------------------------------------------------------
# Ranks and their wire: ring shifts and all-gathers on a torch.distributed
# group (the reference's ppermute and all_gather)
# ---------------------------------------------------------------------------

def group_of(mesh, axis: Optional[str] = None):
    """The process group of ``mesh`` along ``axis`` (a ``DeviceMesh``), or
    None for a world of one (``mesh is None``)."""
    if mesh is None:
        return None
    return mesh.get_group(axis) if axis is not None else mesh.get_group()


def rank_and_size(group=None) -> tuple[int, int]:
    """This process's rank in ``group`` and the group's size.

    ``group=None`` is the default group when torch.distributed is
    initialised, else a world of one (rank 0 of 1) that makes no
    collective call."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def wire_device(group, device: torch.device) -> torch.device:
    """Where the tensors of ``group``'s collectives live: the rank's CUDA
    device on NCCL, the host on gloo, the tensor's own device on torch's
    ``fake`` backend (the dry run's world, ``launch/dryrun.py``, whose
    collectives move nothing).  Nothing switches on its own: NCCL with a
    CPU tensor is refused."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"an NCCL group ships CUDA tensors; the data is "
                             f"on {device} (use a gloo group for the host)")
        return device
    if backend == "gloo":
        return torch.device("cpu")
    if backend == "fake":
        return device
    raise ValueError(f"unsupported process-group backend {backend!r}; "
                     f"pick 'nccl' (CUDA) or 'gloo' (host)")


def _global(group, r: int) -> int:
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def ring_shift(group, sends: list) -> list:
    """The reference's ``ppermute`` ring shifts, all posted in one
    ``batch_isend_irecv``: for each ``(tensor, s)`` of ``sends`` this rank
    sends the tensor to rank (r + s) mod p and receives one of the same
    shape and type from rank (r - s) mod p.  Every rank must call it with
    the same shifts and shapes.  Returns the received tensors on the
    devices of the sent ones."""
    if not sends:
        return []
    rank, p = rank_and_size(group)
    wire = wire_device(group, sends[0][0].device)
    ops, bufs = [], []
    for tag, (x, s) in enumerate(sends):
        xw = x.to(wire).contiguous()
        buf = torch.empty_like(xw)
        ops.append(dist.P2POp(dist.isend, xw, _global(group, (rank + s) % p),
                              group, tag))
        ops.append(dist.P2POp(dist.irecv, buf, _global(group, (rank - s) % p),
                              group, tag))
        bufs.append(buf)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [b.to(x.device) for b, (x, _) in zip(bufs, sends)]


def all_gather(group, x: torch.Tensor) -> torch.Tensor:
    """(p, *x.shape): every rank's ``x`` in rank order, on ``x``'s device.
    A world of one with no group returns ``x[None]`` without a call."""
    rank, p = rank_and_size(group)
    if p == 1 and group is None:
        return x[None]
    xw = x.to(wire_device(group, x.device)).contiguous()
    outs = [torch.empty_like(xw) for _ in range(p)]
    dist.all_gather(outs, xw, group=group)
    return torch.stack(outs).to(x.device)


def _count(comm: Optional[dict], *tensors: torch.Tensor) -> None:
    """Add the bytes of collective results (received, or gathered) to
    ``comm["collective_bytes"]``."""
    if comm is not None:
        comm["collective_bytes"] = comm.get("collective_bytes", 0) + sum(
            t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# The distributed multiply (per-rank body)
# ---------------------------------------------------------------------------

def _owned_mask(grid: int, n_dev: int, dev: int,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """(grid, grid) bool: cells in this rank's Morton range.

    Uses the closed form of the balanced clipped split — owner(z) =
    ((z+1)*n_dev - 1) // cells assigns z to device d iff
    d*cells//n_dev <= z < (d+1)*cells//n_dev — so it agrees with
    :func:`morton_owner` for every n_dev, divisible or not.  It computes
    in int32, as the reference does, which holds while
    grid*grid*n_dev < 2**31; past that it raises.
    """
    cells = grid * grid
    if cells * n_dev >= 2 ** 31:
        raise ValueError(f"_owned_mask: grid {grid} x {grid} on {n_dev} "
                         f"devices exceeds the int32 range of the owner map")
    idx = torch.arange(grid, dtype=torch.int32, device=device)
    r, c = idx[:, None].expand(grid, grid), idx[None, :].expand(grid, grid)
    z = morton.torch_encode(r, c).to(torch.int32)
    owner = torch.div((z + 1) * n_dev - 1, cells, rounding_mode="floor")
    return owner == dev


def _local_spmm(A, Ar, Ac, B, Br, Bc, grid: int, owned: torch.Tensor,
                cap_c: int, pair_caps, use_pair_kernel: bool):
    """One rank's multiply of its halo'd pools: the C blocks it owns.

    Returns (c_blocks, c_rows, c_cols, n_pairs) as the reference's body
    does: the owned C cells in row-major slot order, padded to ``cap_c``.
    """
    g = grid
    slot_a = slot_map(Ar, Ac, g)
    slot_b = slot_map(Br, Bc, g)
    mask_a = slot_a[:g, :g] >= 0
    mask_b = slot_b[:g, :g] >= 0
    mask_c = ((mask_a.float() @ mask_b.float()) > 0) & owned

    crows, ccols = nonzero_padded(mask_c, cap_c, g)
    cslot = slot_map(crows, ccols, g)

    pairs, n_pairs = enumerate_pairs_hier(mask_a, mask_b, list(pair_caps),
                                          mask_c=mask_c)
    pi, pk, pj = (pairs[:, x].long() for x in range(3))
    sa, sb, sc = slot_a[pi, pk], slot_b[pk, pj], cslot[pi, pj]
    pvalid = (sa >= 0) & (sb >= 0) & (sc >= 0)
    seg = torch.where(pvalid, sc, torch.full_like(sc, cap_c))

    if use_pair_kernel:
        from repro_torch.kernels import ops as kops
        order = torch.argsort(seg, stable=True)
        cb = kops.bsmm_pairs(A, B, sa.clamp(min=0)[order],
                             sb.clamp(min=0)[order], seg[order], cap_c=cap_c)
    else:
        prods = torch.einsum("pik,pkj->pij",
                             A[sa.clamp(min=0).long()].float(),
                             B[sb.clamp(min=0).long()].float()).to(A.dtype)
        prods = torch.where(pvalid[:, None, None], prods,
                            torch.zeros((), dtype=A.dtype, device=A.device))
        cb = torch.zeros((cap_c + 1,) + prods.shape[1:], dtype=A.dtype,
                         device=A.device)
        cb.index_add_(0, seg.long(), prods)
        cb = cb[:cap_c]
    return cb, crows, ccols, n_pairs


def _check_world(group, n_dev: int, what: str) -> int:
    rank, p = rank_and_size(group)
    if p != n_dev:
        raise ValueError(f"{what}: the plan is for {n_dev} devices but the "
                         f"group has {p} ranks")
    return rank


def halo_spmm(mesh, axis: str, plan: DistPlan,
              a_blocks, a_rows, a_cols, b_blocks, b_rows, b_cols,
              use_pair_kernel: bool = False, comm: Optional[dict] = None):
    """C = A @ B with Morton ownership and bounded ring halo exchange.

    Every rank of ``mesh``'s ``axis`` group calls it with its own shard:
    ``(cap_d, bs, bs)`` blocks and ``(cap_d,)`` int32 rows and cols, on
    the device the multiply runs on.  Returns this rank's (c_blocks,
    c_rows, c_cols, n_pairs).  Collective footprint: 2 * halo_hops ring
    shifts of the A and B shards — O(1) bytes/device in weak scaling for
    local patterns (Table 1).  After h forward hops of the reference's
    ring a rank holds the shard of rank r - h, so the port ships each
    shard straight to its destination with a shift of h, all in one
    batch: the same blocks and bytes.  ``comm`` (a dict) accumulates the
    bytes received under ``"collective_bytes"``.
    """
    g, n_dev = plan.grid, plan.n_dev
    hops, cap_c = plan.halo_hops, plan.cap_c_d
    group = group_of(mesh, axis)
    dev = _check_world(group, n_dev, "halo_spmm")

    own_a, own_b = (a_blocks, a_rows, a_cols), (b_blocks, b_rows, b_cols)
    sends = []
    for h in range(1, hops + 1):
        for shift in (h, -h):
            sends += [(x, shift) for x in own_a + own_b]
    got = ring_shift(group, sends)
    _count(comm, *got)
    parts = [own_a + own_b] + [tuple(got[i:i + 6])
                               for i in range(0, len(got), 6)]
    A, Ar, Ac, B, Br, Bc = (torch.cat([pt[x] for pt in parts])
                            for x in range(6))
    owned = _owned_mask(g, n_dev, dev, device=A.device)
    return _local_spmm(A, Ar, Ac, B, Br, Bc, g, owned, cap_c,
                       plan.pair_caps, use_pair_kernel)


# ---------------------------------------------------------------------------
# v2: demand-routed sparse halo (beyond-paper optimization, EXPERIMENTS §Perf)
#
# The v1 ring floods every device with every neighbour's full shard out to
# the WORST-CASE owner distance.  Morton quadrant boundaries make that
# distance grow with p for banded matrices (a band cell just across the
# half-matrix boundary lives ~p/4 devices away), so v1's bytes/device grow
# with p — v1 fails to deliver the paper's O(1).
#
# v2 plans, per directed owner-distance s, exactly which blocks any device
# must ship to the device s hops ahead (the paper's "runtime fetches the
# chunks a task needs" made static).  Each active shift becomes ONE
# ring shift whose payload is the max-over-devices shipped-block
# count; inactive shifts vanish.  For banded matrices the active shifts
# are the small neighbourhood + a geometric set of quadrant-boundary
# shifts with tiny payloads -> near-O(1) bytes/device in weak scaling.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DemandPlan:
    grid: int
    bs: int
    n_dev: int
    cap_d: int
    cap_c_d: int
    pair_caps: tuple
    # per active shift: (shift, capA, capB); tables live in arrays below
    shifts: tuple                 # tuple of (s, capA_s, capB_s)
    # selection tables, sharded over devices at call time:
    selA: "np.ndarray"            # (n_shifts, n_dev, max_capA) slot or -1
    selB: "np.ndarray"            # (n_shifts, n_dev, max_capB)

    @property
    def halo_cap(self) -> int:
        return self.cap_d + sum(ca + cb for _, ca, cb in self.shifts)


def _leaf_pairs(mask_a: np.ndarray, mask_b: np.ndarray):
    """All (i, k, j) with A[i,k] and B[k,j] nonzero (planning scale)."""
    ii, kk = np.nonzero(mask_a)
    kb, jb = np.nonzero(mask_b)
    order_a = np.argsort(kk, kind="stable")
    order_b = np.argsort(kb, kind="stable")
    ii, kk = ii[order_a], kk[order_a]
    kb, jb = kb[order_b], jb[order_b]
    g = mask_a.shape[0]
    a_start = np.searchsorted(kk, np.arange(g + 1))
    b_start = np.searchsorted(kb, np.arange(g + 1))
    I, K, J = [], [], []
    for k in range(g):
        a0, a1 = a_start[k], a_start[k + 1]
        b0, b1 = b_start[k], b_start[k + 1]
        if a0 == a1 or b0 == b1:
            continue
        na, nb = a1 - a0, b1 - b0
        I.append(np.repeat(ii[a0:a1], nb))
        K.append(np.full(na * nb, k, np.int64))
        J.append(np.tile(jb[b0:b1], na))
    if not I:
        z = np.empty(0, np.int64)
        return z, z, z
    return np.concatenate(I), np.concatenate(K), np.concatenate(J)


def _local_slot_numbers(mask: np.ndarray, owner: np.ndarray, n_dev: int):
    """slot_of[i, j]: index of block (i,j) within its owner's packed shard
    (row-major fill order — matches distribute_morton)."""
    slot_of = np.full(mask.shape, -1, np.int64)
    fill = np.zeros(n_dev, np.int64)
    for i, j in zip(*np.nonzero(mask)):
        d = owner[i, j]
        slot_of[i, j] = fill[d]
        fill[d] += 1
    return slot_of, fill


def plan_demand(mask_a: np.ndarray, mask_b: np.ndarray, bs: int,
                n_dev: int, slack: float = 1.3, round_to: int = 8
                ) -> DemandPlan:
    grid = mask_a.shape[0]
    owner = morton_owner(grid, n_dev)
    ma, mb = np.asarray(mask_a), np.asarray(mask_b)
    mc = (ma.astype(np.int64) @ mb.astype(np.int64)) > 0

    def _cap(x):
        return max(round_to, int(np.ceil(x * slack / round_to)) * round_to)

    cap_d = _cap(max(np.bincount(owner[ma].ravel(), minlength=n_dev).max(),
                     np.bincount(owner[mb].ravel(), minlength=n_dev).max()))
    cap_c_d = _cap(np.bincount(owner[mc].ravel(), minlength=n_dev).max())

    slotA, _ = _local_slot_numbers(ma, owner, n_dev)
    slotB, _ = _local_slot_numbers(mb, owner, n_dev)

    I, K, J = _leaf_pairs(ma, mb)
    oA, oB, oC = owner[I, K], owner[K, J], owner[I, J]
    sA = (oC - oA) % n_dev
    sB = (oC - oB) % n_dev

    # unique (shift, src_dev, block) shipments
    def shipments(shift_arr, src_dev, slot_of, rows, cols):
        out = {}
        key = (shift_arr.astype(np.int64) << 40) | \
            (src_dev.astype(np.int64) << 24) | slot_of[rows, cols]
        uniq, idx = np.unique(key, return_index=True)
        sh = (uniq >> 40).astype(np.int64)
        sd = ((uniq >> 24) & 0xFFFF).astype(np.int64)
        sl = (uniq & 0xFFFFFF).astype(np.int64)
        for s in np.unique(sh):
            if s == 0:
                continue
            m = sh == s
            out[int(s)] = (sd[m], sl[m])
        return out

    shipA = shipments(sA, oA, slotA, I, K)
    shipB = shipments(sB, oB, slotB, K, J)

    all_shifts = sorted(set(shipA) | set(shipB))
    shifts = []
    selA_list, selB_list = [], []
    for s in all_shifts:
        def table(ship):
            if s not in ship:
                return np.full((n_dev, 1), -1, np.int64), 0
            sd, sl = ship[s]
            counts = np.bincount(sd, minlength=n_dev)
            cap = int(counts.max())
            tbl = np.full((n_dev, cap), -1, np.int64)
            fill = np.zeros(n_dev, np.int64)
            for d, slot in zip(sd, sl):
                tbl[d, fill[d]] = slot
                fill[d] += 1
            return tbl, cap

        ta, ca = table(shipA)
        tb, cb = table(shipB)
        shifts.append((int(s), ca, cb))
        selA_list.append(ta)
        selB_list.append(tb)

    max_ca = max((c for _, c, _ in shifts), default=1) or 1
    max_cb = max((c for _, _, c in shifts), default=1) or 1
    selA = np.full((len(shifts), n_dev, max_ca), -1, np.int64)
    selB = np.full((len(shifts), n_dev, max_cb), -1, np.int64)
    for x, (ta, tb) in enumerate(zip(selA_list, selB_list)):
        selA[x, :, :ta.shape[1]] = ta
        selB[x, :, :tb.shape[1]] = tb

    # per-level pair caps: reuse the exact constrained counter from v1
    base = plan_distribution(mask_a, mask_b, bs, n_dev, slack=slack,
                             round_to=round_to)
    return DemandPlan(grid=grid, bs=bs, n_dev=n_dev, cap_d=cap_d,
                      cap_c_d=cap_c_d, pair_caps=base.pair_caps,
                      shifts=tuple(shifts),
                      selA=selA.astype(np.int32),
                      selB=selB.astype(np.int32))


def demand_spmm(mesh, axis: str, plan: DemandPlan,
                a_blocks, a_rows, a_cols, b_blocks, b_rows, b_cols,
                use_pair_kernel: bool = False, comm: Optional[dict] = None):
    """C = A @ B with demand-routed halo (see the comment above).

    Per rank and active shift, the rank ships exactly the blocks its
    selection tables name (padded to the shift's count), all shifts in one
    ``batch_isend_irecv``.  Arguments and result as :func:`halo_spmm`;
    ``use_pair_kernel`` (not in the reference, whose v2 body is einsum
    only) runs the local multiply through ``bsmm_pairs``.
    """
    g, n_dev = plan.grid, plan.n_dev
    cap_c = plan.cap_c_d
    group = group_of(mesh, axis)
    dev = _check_world(group, n_dev, "demand_spmm")
    sel_a = torch.as_tensor(plan.selA[:, dev], device=a_blocks.device)
    sel_b = torch.as_tensor(plan.selB[:, dev], device=a_blocks.device)

    def pick(blocks, rows, cols, idx):
        ok = idx >= 0
        i = idx.clamp(min=0).long()
        blk = torch.where(ok[:, None, None], blocks[i],
                          torch.zeros((), dtype=blocks.dtype,
                                      device=blocks.device))
        rr = torch.where(ok, rows[i], torch.full_like(rows[i], g))
        cc = torch.where(ok, cols[i], torch.full_like(cols[i], g))
        return blk, rr, cc

    sends, sides = [], []
    for x, (s, ca, cb) in enumerate(plan.shifts):
        if ca:
            sends += [(t, s) for t in pick(a_blocks, a_rows, a_cols,
                                           sel_a[x, :ca])]
            sides.append("a")
        if cb:
            sends += [(t, s) for t in pick(b_blocks, b_rows, b_cols,
                                           sel_b[x, :cb])]
            sides.append("b")
    got = ring_shift(group, sends)
    _count(comm, *got)
    halo = {"a": [(a_blocks, a_rows, a_cols)], "b": [(b_blocks, b_rows,
                                                      b_cols)]}
    for i, side in enumerate(sides):
        halo[side].append(tuple(got[3 * i:3 * i + 3]))
    A, Ar, Ac = (torch.cat([pt[x] for pt in halo["a"]]) for x in range(3))
    B, Br, Bc = (torch.cat([pt[x] for pt in halo["b"]]) for x in range(3))
    owned = _owned_mask(g, n_dev, dev, device=A.device)
    return _local_spmm(A, Ar, Ac, B, Br, Bc, g, owned, cap_c,
                       plan.pair_caps, use_pair_kernel)


# ---------------------------------------------------------------------------
# Collectives of the sharded LM (launch/sharding.py, models/): an
# all-reduce, an all-gather and a reduce-scatter along a dim, and a
# broadcast over a subgroup, each counted; and the autograd pairs the
# tensor-parallel layers are built from
# ---------------------------------------------------------------------------

#: elements one gloo round ships at most (optim.adamw.SLAB's size)
SLAB = 1 << 26


@dataclasses.dataclass
class CommStats:
    """What a rank's collectives moved: ``bytes`` that a ring algorithm
    sends from the rank (an all-reduce of n bytes over p ranks
    2 (p - 1) / p n, an all-gather or a reduce-scatter of a whole of n
    bytes (p - 1) / p n, a broadcast n), ``seconds`` on the host clock,
    and ``gathered``, the bytes each named leaf's all-gathers returned.
    ``per_op`` and ``counts`` split the bytes and the calls by kind, under
    the reference's HLO names (``all-reduce``, ``all-gather``,
    ``reduce-scatter``; ``broadcast``)."""
    bytes: int = 0
    seconds: float = 0.0
    gathered: dict = dataclasses.field(default_factory=dict)
    per_op: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)

    def add(self, nbytes: int, t0: float, kind: str) -> None:
        self.bytes += nbytes
        self.seconds += time.perf_counter() - t0
        self.per_op[kind] = self.per_op.get(kind, 0) + nbytes
        self.counts[kind] = self.counts.get(kind, 0) + 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _wire_copy(group, x: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous copy of ``x`` where ``group`` ships tensors."""
    wire = wire_device(group, x.device)
    return torch.empty(x.shape, dtype=x.dtype, device=wire).copy_(x.detach())


def all_reduce(group, x: torch.Tensor, stats: Optional[CommStats] = None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of every rank's ``x`` over ``group``: a new
    tensor of x's type on x's device.  gloo reduces on the host, at most
    :data:`SLAB` elements a round."""
    t0 = time.perf_counter()
    p = dist.get_world_size(group)
    buf = _wire_copy(group, x)
    for part in buf.view(-1).split(SLAB):
        dist.all_reduce(part, op=op, group=group)
    if stats is not None:
        stats.add(2 * (p - 1) * _nbytes(buf) // p, t0, "all-reduce")
    return buf.to(x.device)


def all_gather_along(group, x: torch.Tensor, dim: int,
                     stats: Optional[CommStats] = None) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks) concatenated along
    ``dim`` in rank order, on x's device."""
    t0 = time.perf_counter()
    p = dist.get_world_size(group)
    xw = _wire_copy(group, x)
    outs = [torch.empty_like(xw) for _ in range(p)]
    dist.all_gather(outs, xw, group=group)
    out = torch.cat(outs, dim)
    if stats is not None:
        stats.add((p - 1) * _nbytes(xw), t0, "all-gather")
    return out.to(x.device)


def reduce_scatter_along(group, x: torch.Tensor, dim: int,
                         stats: Optional[CommStats] = None,
                         dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """This rank's part (the r-th of p equal parts along ``dim``) of the sum
    of every rank's ``x``, in ``dtype`` (x's by default), a new contiguous
    tensor on x's device.  ``dist.reduce_scatter_tensor``, which NCCL has
    and gloo has on torch 2.11 and 2.13; at most :data:`SLAB` elements of
    the whole a round, each converted to ``dtype`` on its way to the
    wire."""
    t0 = time.perf_counter()
    p = dist.get_world_size(group)
    dtype = dtype or x.dtype
    rows = x.detach().movedim(dim, 0)
    whole = rows.reshape(p, -1)
    m = whole.shape[1]
    wire = wire_device(group, x.device)
    out = torch.empty(m, dtype=dtype, device=wire)
    step = max(1, SLAB // p)
    for c in range(0, m, step):
        w = min(step, m - c)
        part = torch.empty((p, w), dtype=dtype, device=wire)
        part.copy_(whole[:, c:c + w])
        dist.reduce_scatter_tensor(out[c:c + w], part.view(-1), group=group)
    if stats is not None:
        stats.add((p - 1) * _nbytes(out), t0, "reduce-scatter")
    out = out.view(rows.shape[0] // p, *rows.shape[1:]).movedim(0, dim)
    return out.to(x.device).contiguous()


def broadcast(group, x: torch.Tensor, src: int = 0,
              stats: Optional[CommStats] = None) -> torch.Tensor:
    """Rank ``src``'s (of ``group``) ``x`` on every rank, a new tensor."""
    t0 = time.perf_counter()
    buf = _wire_copy(group, x)
    for part in buf.view(-1).split(SLAB):
        dist.broadcast(part, src=_global(group, src), group=group)
    if stats is not None:
        stats.add(_nbytes(buf), t0, "broadcast")
    return buf.to(x.device)


class _Sum(torch.autograd.Function):
    """Partial sums -> their total on every rank; the gradient of a
    replicated total is each partial's (identity backward)."""

    @staticmethod
    def forward(ctx, x, group, stats):
        return all_reduce(group, x, stats)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """A replicated tensor entering rank-partitioned work: identity
    forward; each rank's gradient is a part, so backward sums them."""

    @staticmethod
    def forward(ctx, x, group, stats):
        ctx.group, ctx.stats = group, stats
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.group, g, ctx.stats), None, None


class _Gather(torch.autograd.Function):
    """Equal parts along ``dim`` -> the whole on every rank; backward is
    the conjugate reduce-scatter (the whole's gradient summed over the
    ranks, each keeping its part)."""

    @staticmethod
    def forward(ctx, x, dim, group, stats):
        ctx.dim, ctx.group, ctx.stats = dim, group, stats
        return all_gather_along(group, x, dim, stats)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_along(ctx.group, g, ctx.dim, ctx.stats),
                None, None, None)


class ModelGroup:
    """The ranks one tensor-parallel layer spans (a mesh's ``model`` axis),
    as this rank sees them, with the collectives of the layers:

    * :meth:`sum` — partial sums of rank-partitioned work into the
      replicated stream (all-reduce; identity backward);
    * :meth:`enter` — a replicated tensor into rank-partitioned work
      (identity; all-reduce backward); ``sum_inside`` is both, for a total
      that partitioned work reads again (the mamba2 norm, the x_proj of
      mamba1);
    * :meth:`gather` — an all-gather along a dim (reduce-scatter
      backward);
    * :meth:`max` — an all-reduce of maxima (no gradient).

    ``stats`` counts every call.  A group of one rank makes no call."""

    def __init__(self, group, stats: Optional[CommStats] = None):
        self.group = group
        self.rank, self.size = rank_and_size(group)
        self.stats = stats if stats is not None else CommStats()

    def split(self, n: int) -> tuple[int, int]:
        """This rank's contiguous range of ``n`` items (sizes differ by at
        most one)."""
        return self.rank * n // self.size, (self.rank + 1) * n // self.size

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        return _Sum.apply(x, self.group, self.stats)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1 or not torch.is_grad_enabled():
            return x
        return _Enter.apply(x, self.group, self.stats)

    def sum_inside(self, x: torch.Tensor) -> torch.Tensor:
        return self.enter(self.sum(x))

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if self.size == 1:
            return x
        return _Gather.apply(x, dim, self.group, self.stats)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x.detach()
        return all_reduce(self.group, x.detach(), self.stats,
                          op=dist.ReduceOp.MAX)

    def gather_uneven(self, x: torch.Tensor, dim: int, n: int
                      ) -> torch.Tensor:
        """This rank's :meth:`split` part of ``n`` items along ``dim`` ->
        all ``n`` on every rank (no gradient): parts padded to the largest,
        gathered, trimmed."""
        if self.size == 1:
            return x.detach()
        big = -(-n // self.size)
        pad = big - x.shape[dim]
        if pad:
            shape = list(x.shape)
            shape[dim] = pad
            x = torch.cat([x, x.new_zeros(shape)], dim)
        whole = all_gather_along(self.group, x.detach(), dim, self.stats)
        parts = [whole.narrow(dim, r * big, (r + 1) * n // self.size -
                              r * n // self.size) for r in range(self.size)]
        return torch.cat(parts, dim)
