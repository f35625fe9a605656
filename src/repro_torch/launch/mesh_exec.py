"""Device-mesh executor for the quadtree multiply (DESIGN.md §7).

The port of ``repro/launch/mesh_exec.py``.  :class:`MeshEngine` promotes
the simulator's parent-worker placement into an executing backend: every
deferred leaf-engine wave is partitioned over the ranks of a
``torch.distributed`` group, operand blocks move between ranks through
explicit, *counted* ring shifts (:func:`~repro_torch.core.distributed.
ring_shift`, the reference's ``ppermute``), and each rank's block GEMMs
run as one launch of :func:`repro_torch.kernels.ops.batched_gemm` (plus a
segment sum) or :func:`~repro_torch.kernels.ops.bsmm_pairs` per wave.  The
per-device communication volume reported by :meth:`stats` is therefore
*measured from the shipments actually performed*, not derived from the
simulator's cost model.

Every rank runs the same host program (the same ``Session``, the same
tasks in the same order), plans each whole wave with :func:`plan_wave`
from the engine's one wave numbering, which numbers leaves by first
appearance and not by ``id(leaf)``, so every rank plans alike, and runs
only its own share.  Before it ships anything a wave gathers each rank's
counter deltas together with a fingerprint of the plan, and a rank whose
plan differs raises instead of sending mismatched buffers.

Ownership (the paper's parent-worker rendering, §6/Table 1):

* each wave's tasks are split contiguously over the ranks in registration
  order (the quadtree's DFS order, which is Morton/locality order for the
  leaves) using the same closed-form balanced split as
  ``core.distributed``;
* a leaf produced by a task lives on the rank that ran the task;
* an input leaf is homed on the first rank that touches it.

Data movement model per wave (each rank counts its own):

* **push** — host -> home device upload of an operand block not already
  device-resident at its current ``LeafMatrix._version`` (first touch, or
  stale after a plan rebind refilled the leaf);
* **fetch** — a remote operand block a rank needs, shipped from its home
  by a ring shift; counted once per (block, version, rank) — a re-used
  resident block costs nothing, which is exactly the locality the
  parent-worker placement is supposed to buy;
* **collective** — the raw padded payload the ring shifts move (the
  shipping is rectangular: every rank sends and receives the same padded
  count per shift, so this is an upper envelope of fetch).

What is not counted: after its kernel, each rank's C shard is gathered to
every rank, because every rank's host quadtree needs every result leaf
filled (the reference's ``np.asarray(c_dev)`` read-back).  The reference
does not count that read-back, so it stays outside the Table-1 counters;
so does the small per-wave gather of the counters themselves.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import distributed as cdist
from repro_torch.core.engine import (TorchEngine, WaveNumbering, _Pending,
                                     _to_device, number_by_first,
                                     number_wave)
from repro_torch.core.leaf import unpack_blocks

#: counters every rank keeps for itself and the wave gathers, in this order
_COUNTERS = ("fetched_bytes", "fetched_blocks", "pushed_bytes",
             "collective_bytes")


@dataclasses.dataclass
class MeshPlan:
    """One wave's plan as rank ``me`` sees it.  Operand slots are numbered
    jointly over both sides, by first occurrence in the order a0, b0, a1,
    b1, ... of the wave's pairs.  Rank ``h`` holds slots ``own[h]``, the
    first rows of its pool, and sends ``ship[s][h]`` to rank ``(h + s) %
    n_dev`` in that rank's order of need; each rank's pool then has one
    segment of ``cnts[x]`` rows for each shift ``s``, ascending."""
    slot_code: np.ndarray   # each slot's WaveNumbering code
    home: np.ndarray        # each slot's rank
    leaf_homes: dict        # id(leaf) -> rank, for the leaves read
    own: list
    ship: dict
    cnts: list
    send: list              # per shift: this rank's rows to send, padded
    fetch: np.ndarray       # this rank's remote slots, in order of need
    out_base: np.ndarray    # each task's first C slot on its rank
    n_out: list             # per rank: its C slots
    n_pairs: list           # per rank: its pairs
    cap_own: int
    cap_c: int
    cap_p: int
    # this rank's pairs: the pool rows of their operands and their C
    # slot, sorted stably by C slot and padded to cap_p with seg = cap_c
    sa: np.ndarray
    sb: np.ndarray
    seg: np.ndarray


def plan_wave(num: WaveNumbering, owners: np.ndarray, owner_of: dict,
              n_dev: int, me: int) -> MeshPlan:
    """Plan a wave from its numbering, with no collective call and no
    state.  ``owners`` is each task's rank, non-decreasing; ``owner_of``
    maps ``id(leaf)`` to the rank that produced or first read the leaf."""
    two_cells = 2 * num.grid * num.grid
    pair_dev = owners[num.task]
    codes = num.code.ravel()
    joint, first = number_by_first(codes)
    slot_code = codes[first]
    # a leaf new to the mesh is homed on the first rank to read it
    leaf_ix, leaf_first = np.unique(codes // two_cells, return_index=True)
    leaf_homes = {lid: owner_of.get(lid, d) for lid, d in zip(
        [id(num.leaves[x]) for x in leaf_ix.tolist()],
        pair_dev[leaf_first // 2].tolist())}
    leaf_home = np.zeros(len(num.leaves), np.int64)
    leaf_home[leaf_ix] = list(leaf_homes.values())
    home = leaf_home[slot_code // two_cells]
    own = [np.flatnonzero(home == h) for h in range(n_dev)]
    own_pos = np.zeros(len(slot_code), np.int64)
    for o in own:
        own_pos[o] = np.arange(len(o))
    cap_own = max(1, max(map(len, own)))

    pair_run = np.searchsorted(pair_dev, np.arange(n_dev + 1))
    task_run = np.searchsorted(owners, np.arange(n_dev + 1))
    ship: dict = {}
    for d in range(n_dev):
        run = joint[2 * pair_run[d]:2 * pair_run[d + 1]]
        need = run[np.sort(np.unique(run, return_index=True)[1])]
        remote = need[home[need] != d]
        shift = (d - home[remote]) % n_dev
        for s in np.unique(shift).tolist():
            ship.setdefault(s, [np.zeros(0, np.int64)] * n_dev)[
                (d - s) % n_dev] = remote[shift == s]
        if d == me:
            fetch = remote
    ship = dict(sorted(ship.items()))
    cnts = [max(map(len, lists)) for lists in ship.values()]
    pos = own_pos.copy()            # this rank's pool row of each slot
    send, off = [], cap_own
    for (s, lists), cnt in zip(ship.items(), cnts):
        got = lists[(me - s) % n_dev]
        pos[got] = off + np.arange(len(got))
        off += cnt
        send.append(np.zeros(cnt, np.int64))
        send[-1][:len(lists[me])] = own_pos[lists[me]]

    n_out = np.diff(num.slot_base[task_run])
    n_pairs = np.diff(pair_run)
    cap_c, cap_p = max(1, int(n_out.max())), max(1, int(n_pairs.max()))
    mine = joint[2 * pair_run[me]:2 * pair_run[me + 1]].reshape(-1, 2)
    c = num.slot[pair_run[me]:pair_run[me + 1]] - num.slot_base[task_run[me]]
    order = np.argsort(c, kind="stable")
    sa, sb = np.zeros((2, cap_p), np.int32)
    seg = np.full(cap_p, cap_c, np.int32)
    sa[:len(c)], sb[:len(c)] = pos[mine[order]].T
    seg[:len(c)] = c[order]
    return MeshPlan(
        slot_code, home, leaf_homes, own, ship, cnts, send, fetch,
        num.slot_base[:-1] - num.slot_base[task_run[owners]],
        n_out.tolist(), n_pairs.tolist(), cap_own, cap_c, cap_p, sa, sb, seg)


class MeshEngine(TorchEngine):
    """Rank-sharded leaf backend: ``Session(engine="mesh")``.

    Parameters
    ----------
    n_dev : ranks to shard over (default: the group's world size; a
        different count raises — start one rank per device).
    kernel : ``"gemm"`` (batched_gemm + segment-sum scatter, the default)
        or ``"pairs"`` (the fused bsmm_pairs gather-GEMM-scatter).
    device : where this rank's kernel runs; None -> the CUDA device (raises
        without one), ``"cpu"`` runs the kernels' plain versions.
    group : the ``torch.distributed`` group of the ranks.  None is the
        default group when torch.distributed is initialised, else a world
        of one that makes no collective call.  An NCCL group ships CUDA
        tensors; a gloo group ships host tensors (blocks are staged
        through the host) and the kernel still runs on ``device``.

    Inherits the deferral machinery, NIL/structure semantics, host-side
    add/transpose/scale fills and the float32 precision contract of
    :class:`~repro_torch.core.engine.TorchEngine`; only wave *execution*
    (and the communication bookkeeping that comes with it) is replaced.
    """

    name = "mesh"

    def __init__(self, n_dev: Optional[int] = None, kernel: str = "gemm",
                 device=None, group=None):
        super().__init__(kernel=kernel, device=device)
        self.group = group
        self._n_dev_req = n_dev
        self._ready_mesh = False
        self.n_dev = 0                      # resolved at first wave
        self.rank = 0
        # leaf id -> owning rank (parent-worker: producer owns); every rank
        # keeps the whole map, since homes decide the shipping tables
        self._owner: dict[int, int] = {}
        # this rank's residency: slot key (leaf_id, block_key, trans) ->
        # LeafMatrix._version present on this rank's device
        self._resident: dict = {}
        # leaf id -> this rank's device-side output shard, kept so produced
        # blocks stay device-resident between waves; Session.free drops
        # these through free_chunks
        self._dev_out: dict[int, torch.Tensor] = {}
        self._counters = {k: np.zeros(0, np.int64) for k in _COUNTERS}
        self._comm_log: list[dict] = []

    # -- mesh ----------------------------------------------------------------
    def _ensure_mesh(self) -> None:
        if self._ready_mesh:
            return
        rank, world = cdist.rank_and_size(self.group)
        n = self._n_dev_req or world
        if n > world:
            raise ValueError(
                f"MeshEngine: n_dev={n} requested but the process group has "
                f"only {world} ranks (start one rank per device, e.g. with "
                f"repro_torch.launch.mesh.launch_ranks)")
        if n != world:
            raise ValueError(
                f"MeshEngine: n_dev={n} but the process group has {world} "
                f"ranks; pass a group of {n} ranks")
        if world > 1 or self.group is not None:
            cdist.wire_device(self.group, self.device)   # backend check
        self.n_dev, self.rank = n, rank
        self._counters = {k: np.zeros(n, np.int64) for k in _COUNTERS}
        self._ready_mesh = True

    def _collective(self) -> bool:
        """Whether this engine makes collective calls: a group was given,
        or the world has more than one rank."""
        return self.group is not None or self.n_dev > 1

    # -- wave execution ------------------------------------------------------
    def _run_group(self, key: tuple, tasks: list[_Pending]) -> dict:
        """One rank-sharded dispatch of the wave; returns its record."""
        from repro_torch.kernels import ops as kops

        self._ensure_mesh()
        n_dev, me, bs = self.n_dev, self.rank, key[2]
        bsz = bs * bs * 4               # float32 wire format
        t0 = time.perf_counter()
        nt = len(tasks)
        owners = ((np.arange(nt, dtype=np.int64) + 1) * n_dev - 1) // nt
        num = number_wave(tasks, self.tracer)
        plan = plan_wave(num, owners, self._owner, n_dev, me)
        self._owner.update(plan.leaf_homes)
        self._owner.update(zip((id(t.out) for t in tasks), owners.tolist()))

        mine = plan.slot_code[plan.own[me]]
        pushed = self._make_resident(num.blocks(mine))
        fetched = self._make_resident(num.blocks(plan.slot_code[plan.fetch]))
        delta = {"pushed_bytes": pushed * bsz, "fetched_bytes": fetched * bsz,
                 "fetched_blocks": fetched,
                 "collective_bytes": sum(plan.cnts) * bsz}
        own_pool = num.stack(mine, plan.cap_own)

        # the ranks agree on the plan, and learn each other's counters
        fingerprint = hash((nt, len(plan.slot_code), tuple(plan.ship),
                            tuple(plan.cnts), plan.cap_own, plan.cap_c,
                            plan.cap_p, tuple(plan.n_out),
                            tuple(plan.n_pairs)))
        by_dev = self._gather_counters(fingerprint, delta)

        # ship this rank's segments, then one kernel launch on its pool
        kernel, device, tr = self.kernel, self.device, self.tracer
        shipped = sum(len(x) for lists in plan.ship.values() for x in lists)
        if tr.enabled and plan.ship:
            tr.instant("collective.ppermute", track="engine",
                       shifts=len(plan.ship), shipped_blocks=shipped,
                       padded_shipped_blocks=sum(plan.cnts) * n_dev)
        with tr.span("kernel.dispatch", track="engine", kernel=kernel,
                     bs=bs, n_dev=n_dev, pairs=sum(plan.n_pairs)):
            own_dev = _to_device(own_pool, device)
            sends = [(own_dev[torch.from_numpy(sel).to(device)], s)
                     for s, sel in zip(plan.ship, plan.send)]
            got = cdist.ring_shift(self.group, sends) \
                if self._collective() else []
            pool = torch.cat([own_dev] + got) if got else own_dev
            sa_d, sb_d, seg_d = (_to_device(x, device)
                                 for x in (plan.sa, plan.sb, plan.seg))
            if kernel == "pairs":
                c = kops.bsmm_pairs(pool, pool, sa_d, sb_d, seg_d,
                                    cap_c=plan.cap_c)
            else:
                prods = kops.batched_gemm(pool[sa_d.long()], pool[sb_d.long()])
                c = torch.zeros((plan.cap_c + 1, bs, bs), dtype=torch.float32,
                                device=device)
                c.index_add_(0, seg_d.long(), prods)
                c = c[:plan.cap_c]
            c_all = cdist.all_gather(self.group, c) \
                if self._collective() else c[None]
            c_np = c_all.cpu().numpy()

        # scatter into the placeholder out leaves; produced blocks are
        # now resident on their owner (backed by the retained shard)
        for t, dev, base in zip(tasks, owners.tolist(),
                                plan.out_base.tolist()):
            keys = list(t.out.blocks)
            unpack_blocks(t.out, keys, c_np[dev, base:base + len(keys)])
            if dev == me:
                self._dev_out[id(t.out)] = c
                self._make_resident([(t.out, key, False) for key in keys])

        wall = time.perf_counter() - t0
        self._comm_log.append({
            "bs": bs, "n_dev": n_dev, "tasks": nt,
            "pairs": sum(plan.n_pairs), "shifts": len(plan.ship),
            "shipped_blocks": shipped,
            "padded_shipped_blocks": sum(plan.cnts) * n_dev,
            "fetched_blocks": int(sum(by_dev["fetched_blocks"])),
            "pool_len": plan.cap_own + sum(plan.cnts), "cap_c": plan.cap_c,
            "wall_s": wall,
            # this wave's per-device counter deltas, gathered from every
            # rank (exported as Perfetto counter tracks; see
            # obs/export.mesh_stats_events)
            **{f"{k}_by_dev": by_dev[k] for k in _COUNTERS},
        })
        return {
            "kernel": kernel, "bs": bs, "tasks": nt,
            "pairs": sum(plan.n_pairs), "padded_pairs": plan.cap_p * n_dev,
            "unique_blocks": len(plan.slot_code),
            "c_blocks": sum(plan.n_out), "wall_s": wall,
            "bytes_packed": n_dev * (plan.cap_own + plan.cap_c) * bsz,
        }

    def _make_resident(self, blocks: list) -> int:
        """Record ``(leaf, key, transpose)`` blocks as resident on this
        rank at their leaf's version; returns how many were not."""
        stale = {(id(leaf), key, tr): getattr(leaf, "_version", 0)
                 for leaf, key, tr in blocks}
        stale = {sk: v for sk, v in stale.items()
                 if self._resident.get(sk) != v}
        self._resident.update(stale)
        return len(stale)

    def _gather_counters(self, fingerprint: int, delta: dict) -> dict:
        """Every rank's counter deltas of this wave, by rank; raises if the
        ranks planned different waves.  Adds them to the running sums."""
        mine = torch.tensor([fingerprint] + [delta[k] for k in _COUNTERS],
                            dtype=torch.int64)
        if self._collective():
            rows = cdist.all_gather(
                self.group, mine.to(cdist.wire_device(self.group,
                                                      self.device))).cpu()
        else:
            rows = mine[None]
        if bool((rows[:, 0] != rows[0, 0]).any()):
            raise RuntimeError(
                "MeshEngine: the ranks planned different waves; every rank "
                "must run the same host program (same session, same tasks, "
                "same order)")
        by_dev = {}
        for x, k in enumerate(_COUNTERS):
            col = rows[:, 1 + x].numpy()
            self._counters[k] += col
            by_dev[k] = col.tolist()
        return by_dev

    def _wave_span_attrs(self) -> dict:
        """Wave span attrs: batch shape plus, for a multiply wave, this
        wave's per-device comm deltas (the Table-1 metric, measured).  A
        triangular-solve wave (inherited, run on every rank alone) has no
        comm record; the reference's executor reads the last one anyway
        and fails when there is none."""
        attrs = super()._wave_span_attrs()
        if self._waves[-1]["kernel"] != self.kernel:
            return attrs
        c = self._comm_log[-1]
        attrs.update({k: c[k] for k in
                      ("n_dev", "shifts", "shipped_blocks",
                       "fetched_bytes_by_dev", "pushed_bytes_by_dev",
                       "collective_bytes_by_dev")})
        return attrs

    # -- lifecycle -----------------------------------------------------------
    def free_chunks(self, g, nids) -> None:
        """Drop ownership, residency and device shards of freed leaves."""
        freed: set[int] = set()
        for nid in nids:
            chunk = g.value_of(nid)
            leaf = getattr(chunk, "leaf", None)
            if leaf is not None:
                freed.add(id(leaf))
        if not freed:
            return
        for lid in freed:
            self._owner.pop(lid, None)
            self._dev_out.pop(lid, None)
        for sk in [sk for sk in self._resident if sk[0] in freed]:
            del self._resident[sk]

    # -- reporting -----------------------------------------------------------
    def stats(self) -> dict:
        """The wave stats plus the per-device counters, gathered from every
        rank at each wave.  ``device_blocks`` and ``device_leaves`` are what
        this rank holds (every device's, in a world of one)."""
        out = super().stats()
        out.update({
            "n_dev": self.n_dev,
            **{k: self._counters[k].tolist() for k in _COUNTERS},
            "device_blocks": len(self._resident),
            "device_leaves": len(self._dev_out),
            "comm_log": list(self._comm_log),
        })
        return out
