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
tasks in the same order), computes the same global wave plan and executes
only its own share.  Plan tables are keyed by ``id(leaf)``, which differs
between processes, so every order here is insertion order or pair order,
never an order of those keys.  Before it ships anything a wave gathers
each rank's counter deltas together with a fingerprint of the plan, and a
rank whose plan differs raises instead of sending mismatched buffers.

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

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import distributed as cdist
from repro_torch.core.engine import TorchEngine, _Pending, _to_device
from repro_torch.core.leaf import unpack_blocks

#: counters every rank keeps for itself and the wave gathers, in this order
_COUNTERS = ("fetched_bytes", "fetched_blocks", "pushed_bytes",
             "collective_bytes")


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
    block_t : batch tile of the reference's batched_gemm kernel (kept for
        the wave record; the CUDA kernel needs no padding).
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
                 device=None, block_t: int = 8, group=None):
        super().__init__(kernel=kernel, device=device, block_t=block_t)
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
    def _run_group(self, bs: int, tasks: list[_Pending]) -> None:
        """One rank-sharded dispatch for every block pair of the wave."""
        from repro_torch.kernels import ops as kops

        self._ensure_mesh()
        n_dev, me = self.n_dev, self.rank
        bsz = bs * bs * 4               # float32 wire format
        t0 = time.perf_counter()

        # 1. task ownership: contiguous balanced split in registration
        # (quadtree DFS ~ Morton) order — core.distributed's closed form
        nt = len(tasks)
        owners = ((np.arange(nt, dtype=np.int64) + 1) * n_dev - 1) // nt
        owners = owners.astype(np.int32)

        # 2. operand slots: one per distinct (leaf, key, transpose),
        # homed on the leaf's owning rank (producer, else first touch)
        slot_home: dict[tuple, int] = {}
        slot_leaf: dict[tuple, object] = {}
        needs: list[dict] = [dict() for _ in range(n_dev)]  # ordered sets
        for t, dev in zip(tasks, owners):
            dev = int(dev)
            self._owner[id(t.out)] = dev
            srcs = {"a": t.a_leaf, "b": t.b_leaf}
            for src_a, ka, tra, src_b, kb, trb, _ in t.pairs:
                for src, kk, tr in ((src_a, ka, tra), (src_b, kb, trb)):
                    leaf = srcs[src]
                    sk = (id(leaf), kk, tr)
                    if sk not in slot_home:
                        slot_home[sk] = self._owner.setdefault(id(leaf), dev)
                        slot_leaf[sk] = leaf
                    needs[dev].setdefault(sk)

        def version(sk):
            return getattr(slot_leaf[sk], "_version", 0)

        # 3. per-rank own pools (+ push accounting on this rank: host ->
        # device uploads of blocks not resident at their current version)
        delta = dict.fromkeys(_COUNTERS, 0)
        own_keys: list[list] = [[] for _ in range(n_dev)]
        own_pos: dict[tuple, int] = {}
        for sk, h in slot_home.items():
            own_pos[sk] = len(own_keys[h])
            own_keys[h].append(sk)
            if h == me and self._resident.get(sk) != version(sk):
                self._resident[sk] = version(sk)
                delta["pushed_bytes"] += bsz
        cap_own = max(1, max((len(k) for k in own_keys), default=1))
        own_pool = np.zeros((cap_own, bs, bs), np.float32)
        for i, sk in enumerate(own_keys[me]):
            blk = slot_leaf[sk].blocks[sk[1]]
            own_pool[i] = blk.T if sk[2] else blk

        # 4. shipments grouped by ring shift s = (dst - home) mod n_dev;
        # every rank sends the same padded count per shift
        ship: dict[int, list[list]] = {}    # shift -> per-src slot keys
        ship_pos: dict[tuple, int] = {}     # (shift, slot key) -> position
        for d in range(n_dev):
            for sk in needs[d]:
                h = slot_home[sk]
                if h == d:
                    continue
                s = (d - h) % n_dev
                lst = ship.setdefault(s, [[] for _ in range(n_dev)])[h]
                ship_pos[(s, sk)] = len(lst)
                lst.append(sk)
                if d == me and self._resident.get(sk) != version(sk):
                    self._resident[sk] = version(sk)
                    delta["fetched_bytes"] += bsz
                    delta["fetched_blocks"] += 1
        shifts = sorted(ship)
        cnts = [max(len(lst) for lst in ship[s]) for s in shifts]
        delta["collective_bytes"] = sum(cnts) * bsz   # this rank receives
        # pool position of slot sk as seen by rank d: the own segment,
        # then one recv segment per shift at a static offset
        seg_off = {}
        off = cap_own
        for s, cnt in zip(shifts, cnts):
            seg_off[s] = off
            off += cnt
        pool_len = off

        def pos_on(d: int, sk: tuple) -> int:
            h = slot_home[sk]
            if h == d:
                return own_pos[sk]
            s = (d - h) % n_dev
            return seg_off[s] + ship_pos[(s, sk)]

        # 5. pair tables (sa/sb into the halo'd pool, seg into the
        # rank-local output slots; cap-padded, seg=cap_c invalid)
        out_base: list[int] = []
        n_out = [0] * n_dev
        for t, dev in zip(tasks, owners):
            out_base.append(n_out[int(dev)])
            n_out[int(dev)] += len(t.out.blocks)
        cap_c = max(1, max(n_out))
        my_pairs: list = []
        n_pairs = [0] * n_dev
        for t, dev, base in zip(tasks, owners, out_base):
            dev = int(dev)
            n_pairs[dev] += len(t.pairs)
            if dev != me:
                continue
            key_slot = {key: base + i
                        for i, key in enumerate(t.out.blocks)}
            srcs = {"a": t.a_leaf, "b": t.b_leaf}
            for src_a, ka, tra, src_b, kb, trb, out_key in t.pairs:
                my_pairs.append(
                    (pos_on(me, (id(srcs[src_a]), ka, tra)),
                     pos_on(me, (id(srcs[src_b]), kb, trb)),
                     key_slot[out_key]))
        cap_p = max(1, max(n_pairs))
        sa = np.zeros(cap_p, np.int32)
        sb = np.zeros(cap_p, np.int32)
        seg = np.full(cap_p, cap_c, np.int32)
        # ascending output slots (bsmm_pairs accumulation contract; the
        # cap_c padding sorts to the tail); the sort is stable
        for i, (pa, pb, pc) in enumerate(sorted(my_pairs,
                                                key=lambda x: x[2])):
            sa[i], sb[i], seg[i] = pa, pb, pc

        # the ranks agree on the plan, and learn each other's counters
        fingerprint = hash((nt, len(slot_home), tuple(shifts), tuple(cnts),
                            cap_own, cap_c, cap_p, tuple(n_out),
                            tuple(n_pairs)))
        by_dev = self._gather_counters(fingerprint, delta)

        # 6. ship this rank's segments, then one kernel launch on its pool
        kernel, device = self.kernel, self.device
        tr = self.tracer
        if tr.enabled and shifts:
            tr.instant("collective.ppermute", track="engine",
                       shifts=len(shifts),
                       shipped_blocks=int(sum(len(lst) for s in shifts
                                              for lst in ship[s])),
                       padded_shipped_blocks=int(sum(cnts) * n_dev))
        with tr.span("kernel.dispatch", track="engine", kernel=kernel,
                     bs=bs, n_dev=n_dev, pairs=int(sum(n_pairs))):
            own_dev = _to_device(own_pool, device)
            sends = []
            for s, cnt in zip(shifts, cnts):
                sel = np.zeros(cnt, np.int64)
                for i, sk in enumerate(ship[s][me]):
                    sel[i] = own_pos[sk]
                sends.append((own_dev[torch.from_numpy(sel).to(device)], s))
            got = cdist.ring_shift(self.group, sends) \
                if self._collective() else []
            pool = torch.cat([own_dev] + got) if got else own_dev
            sa_d, sb_d, seg_d = (_to_device(x, device) for x in (sa, sb, seg))
            if kernel == "pairs":
                c = kops.bsmm_pairs(pool, pool, sa_d, sb_d, seg_d,
                                    cap_c=cap_c)
            else:
                prods = kops.batched_gemm(pool[sa_d.long()], pool[sb_d.long()])
                c = torch.zeros((cap_c + 1, bs, bs), dtype=torch.float32,
                                device=device)
                c.index_add_(0, seg_d.long(), prods)
                c = c[:cap_c]
            c_all = cdist.all_gather(self.group, c) \
                if self._collective() else c[None]
            c_np = c_all.cpu().numpy()

        # 7. scatter into the placeholder out leaves; produced blocks are
        # now resident on their owner (backed by the retained shard)
        for t, dev, base in zip(tasks, owners, out_base):
            dev = int(dev)
            keys = list(t.out.blocks)
            unpack_blocks(t.out, keys, c_np[dev, base:base + len(keys)])
            if dev == me:
                self._dev_out[id(t.out)] = c
                ver = getattr(t.out, "_version", 0)
                for key in keys:
                    self._resident[(id(t.out), key, False)] = ver

        wall = time.perf_counter() - t0
        shipped = sum(len(lst) for s in shifts for lst in ship[s])
        self._waves.append({
            "kernel": kernel, "bs": bs, "tasks": nt, "pairs": sum(n_pairs),
            "padded_pairs": int(cap_p * n_dev),
            "unique_blocks": len(slot_home), "c_blocks": int(sum(n_out)),
            "wall_s": wall,
            "bytes_packed": int(n_dev * (cap_own + cap_c) * bsz),
        })
        self._comm_log.append({
            "bs": bs, "n_dev": n_dev, "tasks": nt, "pairs": sum(n_pairs),
            "shifts": len(shifts), "shipped_blocks": int(shipped),
            "padded_shipped_blocks": int(sum(cnts) * n_dev),
            "fetched_blocks": int(sum(by_dev["fetched_blocks"])),
            "pool_len": int(pool_len), "cap_c": int(cap_c),
            "wall_s": wall,
            # this wave's per-device counter deltas, gathered from every
            # rank (exported as Perfetto counter tracks; see
            # obs/export.mesh_stats_events)
            **{f"{k}_by_dev": by_dev[k] for k in _COUNTERS},
        })

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
