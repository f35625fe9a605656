"""Checkpoint save/restore with async write and atomic commit (the port of
``repro/checkpoint/store.py``).

Layout (one directory per step), the reference's:

    <dir>/step_00000100/
        manifest.json        # tree structure, shapes, dtypes, step
        leaf_00000.npy ...   # one file per tree leaf, copied to the host
    <dir>/step_00000100.COMMITTED   # marker written last

Leaves are walked in the order of ``jax.tree_util.tree_flatten``: dict keys
sorted, tuple and NamedTuple fields in order, ``None`` holding no leaf,
anything else (a tensor, an array, a Python number) one leaf.  bfloat16 is
stored as float32 (exact) under its own dtype name.  So a checkpoint the
reference wrote restores into the port, and the other way round; the
manifest's ``treedef`` is this module's own description of the structure,
which neither side reads back.

* ``CheckpointManager`` copies the tree to the host on the caller's thread
  (a consistent snapshot: training may update tensors in place as soon as
  ``save`` returns), writes it on a worker thread, keeps the last ``keep``
  checkpoints, and ``restore_latest`` ignores uncommitted (partially
  written) directories — a crash during a save is safe;
* restore takes a ``device``, and like the reference a tree of
  shardings (here partition specs on a mesh): each rank then restores
  its own blocks.
"""
from __future__ import annotations

import concurrent.futures as futures
import json
import pathlib
import shutil
from typing import Any, Optional

import numpy as np
import torch


class _Leaf:
    """Placeholder of leaf ``i`` in a flattened tree's structure."""

    def __init__(self, i: int):
        self.i = i

    def __repr__(self) -> str:
        return "*"


def _flatten(tree, spec_leaves: bool = False) -> tuple[list, Any]:
    """(leaves in the reference's order, the structure with placeholders).
    With ``spec_leaves`` a plain tuple is one leaf (a partition spec)."""
    leaves: list = []

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(x[k]) for k in sorted(x)}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(y) for y in x))
        if isinstance(x, (tuple, list)) and not spec_leaves:
            return type(x)(walk(y) for y in x)
        if x is None:
            return None
        leaves.append(x)
        return _Leaf(len(leaves) - 1)

    return leaves, walk(tree)


def _unflatten(structure, leaves: list):
    def walk(x):
        if isinstance(x, _Leaf):
            return leaves[x.i]
        if isinstance(x, dict):
            return {k: walk(y) for k, y in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(y) for y in x))
        if isinstance(x, (tuple, list)):
            return type(x)(walk(y) for y in x)
        return x

    return walk(structure)


def _to_host(leaf):
    """A copy of ``leaf`` on the host: a CPU tensor or a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(an ``.npy``-safe array, the leaf's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        dtype = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.float()                      # npy-safe container (exact)
        return t.numpy(), dtype
    arr = np.asarray(leaf)
    dtype = str(arr.dtype)
    if arr.dtype.kind == "V" or dtype == "bfloat16":
        arr = arr.astype(np.float32)
    return arr, dtype


def save_checkpoint(directory, step: int, tree, *, blocking: bool = True
                    ) -> pathlib.Path:
    """Write a checkpoint; returns the committed path."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    dest = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    leaves, structure = _flatten(tree)
    manifest = {"step": step, "treedef": repr(structure), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        np.save(tmp / f"leaf_{i:05d}.npy", arr)
        manifest["leaves"].append({"shape": list(arr.shape), "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if dest.exists():
        shutil.rmtree(dest)
    tmp.rename(dest)                               # atomic commit
    (directory / f"step_{step:08d}.COMMITTED").touch()
    return dest


def load_checkpoint(directory, step: int, like, *, device=None,
                    shardings=None, mesh=None, coords=None):
    """Restore into the structure of ``like``.

    A tensor leaf of ``like`` comes back as a tensor of its dtype, on
    ``device`` (default: that leaf's own device); any other leaf comes back
    as a numpy array of its type.  ``shardings`` (a matching tree of
    partition specs, ``launch.sharding``'s tables) restores this rank's
    block of each leaf on ``mesh`` (a DeviceMesh, or ``{axis: size}`` with
    the rank's ``coords``): the cross-mesh restore, whatever layout the
    checkpoint was saved from.  ``like``'s leaves then have either the
    saved shape or the block's.  Returns (tree, step)."""
    directory = pathlib.Path(directory)
    src = directory / f"step_{step:08d}"
    if not (directory / f"step_{step:08d}.COMMITTED").exists():
        raise FileNotFoundError(f"checkpoint step {step} not committed")
    manifest = json.loads((src / "manifest.json").read_text())
    leaves, structure = _flatten(like)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint step {step} holds "
                         f"{len(manifest['leaves'])} leaves, the tree "
                         f"{len(leaves)}")
    specs = [None] * len(leaves)
    if shardings is not None:
        specs = _flatten(shardings, spec_leaves=True)[0]
    out = []
    for i, (ref, spec) in enumerate(zip(leaves, specs)):
        arr = np.load(src / f"leaf_{i:05d}.npy")
        shapes = {tuple(arr.shape)}
        if spec is not None:
            from repro_torch.launch.sharding import block_slices
            cut = block_slices(arr.shape, spec, mesh, coords)
            arr = arr[tuple(slice(a, a + n) for a, n in cut)]
            shapes.add(tuple(arr.shape))
        ref_shape = tuple(getattr(ref, "shape", np.shape(ref)))
        if ref_shape not in shapes:
            raise ValueError(f"leaf {i}: {arr.shape} != {ref_shape}")
        if isinstance(ref, torch.Tensor):
            out.append(torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=ref.device if device is None else device,
                dtype=ref.dtype))
        else:
            out.append(arr.astype(np.asarray(ref).dtype))
    return _unflatten(structure, out), manifest["step"]


def latest_step(directory) -> Optional[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = sorted(int(p.stem.split("_")[1])
                   for p in directory.glob("step_*.COMMITTED"))
    return steps[-1] if steps else None


class CheckpointManager:
    """Async save + retention + latest-restore."""

    def __init__(self, directory, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._pool = futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[futures.Future] = None

    def save(self, step: int, tree, blocking: bool = False):
        self.wait()
        # the host copy on the caller's thread (consistent snapshot), the
        # write on the worker
        leaves, structure = _flatten(tree)
        host_tree = _unflatten(structure, [_to_host(x) for x in leaves])
        if blocking:
            save_checkpoint(self.directory, step, host_tree)
            self._gc()
            return
        self._pending = self._pool.submit(self._save_and_gc, step,
                                          host_tree)

    def _save_and_gc(self, step, host_tree):
        save_checkpoint(self.directory, step, host_tree)
        self._gc()

    def _gc(self):
        steps = sorted(int(p.stem.split("_")[1])
                       for p in self.directory.glob("step_*.COMMITTED"))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)
            (self.directory / f"step_{s:08d}.COMMITTED").unlink(
                missing_ok=True)

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def restore_latest(self, like, device=None):
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return load_checkpoint(self.directory, step, like, device=device)
