"""The dry run: every (arch x shape x mesh) cell's per-device FLOPs, bytes,
collectives and memory, counted without a card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out experiments/dryrun
    PYTHONPATH=src python -m repro_torch.launch.report experiments/dryrun

The reference lowers and compiles each cell for 256 or 512 forced host
devices and reads XLA's ``memory_analysis``, ``cost_analysis`` and the
collectives of the HLO.  The port has no compiler to ask.  Instead one
process plays one rank of the 16x16 (256 ranks) or 2x16x16 (512 ranks)
mesh on torch's ``fake`` process-group backend (:func:`fake_world`),
whose collectives return at once and move nothing, and runs that rank's
real step — ``TrainStep.step_fn`` with its microbatching and ZeRO-1,
``make_prefill_fn``, ``ServeStep.step_fn`` — on ``meta`` tensors of its
blocks (``abstract_inputs``).  Meta tensors hold no data, so nothing is
computed and no device memory is touched; :class:`Count` sees every op
that executes:

* ``flops``: the matmul, bmm, convolution and attention ops by the
  formulas of ``torch.utils.flop_counter``, plus each hand-written
  kernel's own (``kernels/ops.py`` on meta, ``roofline.kernel_work``).
  Elementwise work is not counted; XLA's count includes it;
* ``hbm``: the input plus output bytes of every executed aten op (views
  and bare allocations move nothing and are skipped), and each kernel's
  bytes by its formula.  Eager PyTorch reads and writes each op's
  operands once and fuses nothing, so this is the eager program's
  traffic, not a fused program's;
* ``coll``: the bytes the step's ``CommStats`` counted — what a ring
  algorithm sends from the rank — with ``coll_per_op`` and
  ``coll_counts`` under the reference's collective names;
* ``mem``: ``argument_bytes``, the bytes of the inputs the step reads
  (an input no op reads is left out, as XLA prunes an unused argument:
  the weights of a non-parametric norm in a prefill or decode);
  ``temp_bytes``, the peak of live tensor bytes made during the step, as
  storages are made and freed; ``output_bytes``, the bytes of what the
  step returns; ``peak_bytes`` = arguments + temps.

Every layer executes, so the count needs no depth extrapolation (the
reference fits ``cost(L) = a + b L`` because XLA counts a scan body once).
:func:`run_cell` counts every cell with ``cost_mode`` on, as the
reference's cost compiles do: a train step is one pass over the rank's
whole batch (no microbatches) and attention and scans run in their large
chunks.  At the configs' own chunk sizes a train or full-attention
prefill cell makes hundreds of thousands of meta ops, 2 to 30 minutes of
host time a cell; a decode step is the same program either way.
:func:`count_cell` counts the config it is given.  A decode step is
counted at ``pos = seq_len - 1`` (the whole cache in use).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import sys
import time
import traceback
import weakref
from collections.abc import Mapping

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.distributed import CommStats
from repro_torch.kernels import ops
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import production_layout
from repro_torch.launch.sharding import (ServeStep, TrainStep,
                                         make_prefill_fn, release_groups)
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES_BY_NAME, applicable_shapes


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode counts one new token."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # decode: 1 token


# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
#: ops that only make storage: they read and write nothing
_ALLOCATIONS = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                _aten.new_empty, _aten.new_empty_strided}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in _pytree_leaves(tree) if isinstance(t, torch.Tensor)]


class Count(TorchDispatchMode):
    """Counts what executes while it is active: ``flops`` and ``hbm`` (see
    the module docstring), per kernel ``kernels`` ``{name: {"calls",
    "flops", "bytes"}}``, ``live`` / ``peak``, the bytes of the storages
    made under the mode that are alive now / were alive at most (storages
    made before it, the arguments, are not counted), and ``read``, the
    storages (their ``_cdata``) that an op which is no view read."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0
        self.hbm = 0
        self.kernels: dict = {}
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self.read: set = set()

    def __enter__(self):
        ops.META_COUNTS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.META_COUNTS.remove(self._kernel)
        return super().__exit__(*exc)

    def _kernel(self, name: str, flops: float, nbytes: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        self.flops += int(flops)
        self.hbm += int(nbytes)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self._formulas:
            self.flops += int(self._formulas[packet](*args, **kwargs,
                                                     out_val=out))
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        keys = {t.untyped_storage()._cdata for t in ins}
        if not (func.is_view or packet in _ALLOCATIONS
                or func.namespace in ("c10d", "_c10d_functional")):
            self.read.update(keys)
            self.hbm += sum(_nbytes(t) for t in ins)
            self.hbm += sum(_nbytes(t) for t in outs)
        for t in outs:
            # a view or an in-place result is an input's storage
            if t.untyped_storage()._cdata not in keys:
                self._track(t)
        return out


# ---------------------------------------------------------------------------
# one rank of a mesh on the fake backend
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(mesh: Mapping, coords=None):
    """A DeviceMesh of ``mesh`` (``{axis: size}``) in which this process is
    the rank at ``coords`` (default: the origin), on torch's ``fake``
    process-group backend: every collective returns at once and moves
    nothing.  The process must have no process group; the world is
    destroyed on exit."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise ValueError("fake_world: this process already has a process "
                         "group; the dry run plays one rank of a world of "
                         "its own")
    names, shape = tuple(mesh), tuple(mesh.values())
    coords = coords or {a: 0 for a in names}
    rank = 0
    for a, n in zip(names, shape):
        rank = rank * n + coords[a]
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    dm = None
    try:
        dm = init_device_mesh("cpu", shape, mesh_dim_names=names)
        yield dm
    finally:
        if dm is not None:
            release_groups(dm)
        dist.destroy_process_group()


def cell_step(cfg, shape, mesh):
    """``(args, step, stats)`` of the cell's entry point on ``mesh`` (a
    DeviceMesh of this rank): its meta inputs, the step to call on them,
    and a callable that gives the step's CommStats after the call.  A
    decode step reads ``pos`` as a number (``int(pos)``), so it is given
    one and its meta input is read by no op (:func:`count_cell` counts it
    where attention reads it)."""
    if shape.kind == "train":
        builder = TrainStep(cfg, mesh)
        args = builder.abstract_inputs(shape)
        return args, builder.step_fn(shape), lambda: builder.stats
    if shape.kind == "prefill":
        params, _, batch = TrainStep(cfg, mesh).abstract_inputs(shape)
        fn = make_prefill_fn(cfg, mesh)
        return (params, batch), fn, \
            lambda: fn.tp.stats if fn.tp is not None else CommStats()
    builder = ServeStep(cfg, mesh, shape)
    args = builder.abstract_inputs()
    step = builder.step_fn()

    def decode(params, token, cache, pos):
        # pos is data: the whole cache in use
        return step(params, token, cache, shape.seq_len - 1)
    return args, decode, lambda: builder.tp.stats


def _unique_bytes(tensors) -> int:
    seen, n = set(), 0
    for t in tensors:
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            n += t.untyped_storage().nbytes()
    return n


def count_cell(cfg, shape, mesh, coords=None) -> dict:
    """Count one rank's step of the cell ``(cfg, shape)``.

    ``mesh`` is a ``{axis: size}`` dict — the rank at ``coords`` (default:
    the origin) of a :func:`fake_world` made for the count — or a
    DeviceMesh of an initialised fake world (this process's rank).
    Returns ``{"flops", "hbm", "coll", "coll_per_op", "coll_counts",
    "kernels", "mem": {argument_bytes, output_bytes, temp_bytes,
    peak_bytes}, "t_inputs_s", "t_count_s"}``."""
    if isinstance(mesh, Mapping):
        with fake_world(mesh, coords) as dm:
            return count_cell(cfg, shape, dm)
    t0 = time.perf_counter()
    args, step, stats_of = cell_step(cfg, shape, mesh)
    t1 = time.perf_counter()
    count = Count()
    with count:
        out = step(*args)
        output_bytes = _unique_bytes(_tensors(out))
    t2 = time.perf_counter()
    if shape.kind == "decode" and "k" in M.cache_shapes(cfg, 1, 1):
        # the position indexes the kv cache (a state-space decode does
        # not read it)
        count.read.add(args[-1].untyped_storage()._cdata)
    arg_bytes = sum(_nbytes(t) for t in _tensors(args)
                    if t.untyped_storage()._cdata in count.read)
    stats = stats_of()
    return {
        "flops": count.flops, "hbm": count.hbm, "coll": stats.bytes,
        "coll_per_op": dict(stats.per_op), "coll_counts": dict(stats.counts),
        "kernels": count.kernels,
        "mem": {"argument_bytes": arg_bytes, "output_bytes": output_bytes,
                "temp_bytes": count.peak,
                "peak_bytes": arg_bytes + count.peak},
        "t_inputs_s": t1 - t0, "t_count_s": t2 - t1,
    }


def production_mesh_sizes(multi_pod: bool) -> dict:
    """``{axis: size}`` of the 16x16 or 2x16x16 production mesh."""
    shape, names = production_layout(multi_pod)
    return dict(zip(names, shape))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, skip_costs: bool = False) -> dict:
    """One row in the reference's schema, ``launch/report.py`` reads it.
    ``t_lower_s`` is the seconds to build the rank's inputs and step,
    ``t_compile_s`` the seconds of the count; ``raw`` holds the count's
    ``flops``, ``hbm`` and ``coll``.  With ``skip_costs`` (the multi-pod
    rows) the row carries memory only, as the reference's.  The config
    is counted with ``cost_mode`` on (module docstring)."""
    cfg = dataclasses.replace(get_config(arch), cost_mode=True)
    shape = SHAPES_BY_NAME[shape_name]
    sizes = production_mesh_sizes(multi_pod)
    n_chips = math.prod(sizes.values())
    costs = count_cell(cfg, shape, sizes)
    hw = RL.Hardware()
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, sizes.values())),
        "n_chips": n_chips,
        "t_lower_s": round(costs["t_inputs_s"], 1),
        "t_compile_s": round(costs["t_count_s"], 1),
        "mem": costs["mem"],
        "raw": {k: costs[k] for k in ("flops", "hbm", "coll")}
        if verbose else None,
    }
    if not skip_costs:
        rf = RL.from_counted(costs, n_chips, hw, model_flops(cfg, shape))
        result["collectives"] = {k: v for k, v in
                                 costs["coll_per_op"].items() if v}
        result["collective_counts"] = {k: v for k, v in
                                       costs["coll_counts"].items() if v}
        result["roofline"] = rf.row()

    if verbose:
        m = result["mem"]
        print(f"[{arch} x {shape_name} x {result['mesh']}] "
              f"inputs {costs['t_inputs_s']:.1f}s count "
              f"{costs['t_count_s']:.1f}s")
        print(f"  memory/device: args {m['argument_bytes']/1e9:.2f} GB"
              f" + temps {m['temp_bytes']/1e9:.2f} GB"
              f" = {m['peak_bytes']/1e9:.2f} GB  (HBM "
              f"{hw.hbm_bytes/1e9:.0f} GB)")
        if "roofline" in result:
            r = result["roofline"]
            print(f"  roofline: compute {r['t_compute_s']*1e3:.2f} ms | "
                  f"memory {r['t_memory_s']*1e3:.2f} ms | "
                  f"collective {r['t_collective_s']*1e3:.2f} ms  "
                  f"-> {r['bottleneck']}-bound; useful flops "
                  f"{r['useful_fraction']*100:.0f}%, MFU bound "
                  f"{r['mfu_bound']*100:.1f}%")
        sys.stdout.flush()
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch id (see repro_torch.configs) or 'all'")
    ap.add_argument("--shape", default=None,
                    help="train_4k|prefill_32k|decode_32k|long_500k|all")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod",
                                                      "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args()

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    archs = list(ARCH_IDS) if (args.all or args.arch in (None, "all")) \
        else [args.arch]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        cfg = get_config(arch)
        shapes = [s.name for s in applicable_shapes(cfg)] \
            if args.shape in (None, "all") else [args.shape]
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape_name}_{'mp' if mp else 'sp'}"
                if args.skip_existing and (outdir / f"{tag}.json").exists():
                    print(f"[{tag}] skipped (exists)")
                    continue
                try:
                    # the roofline table is single-pod; a multi-pod row
                    # shows that the pod axis shards (memory only)
                    res = run_cell(arch, shape_name, mp, skip_costs=mp)
                    (outdir / f"{tag}.json").write_text(
                        json.dumps(res, indent=1))
                except Exception as e:  # noqa: BLE001
                    failures.append((tag, repr(e)))
                    print(f"[{tag}] FAILED: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} cells failed:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        return 1
    print("\nall cells counted OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
