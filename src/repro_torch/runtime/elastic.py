"""Elastic re-scaling: re-plan the mesh after losing nodes (the port of
``repro/runtime/elastic.py``).

Policy for the production 16x16 pod (DESIGN.md):

* the model axis must keep its size (tensor-parallel degree is baked into
  the layer math), so capacity changes come out of the **data axis**;
* losing up to d-1 data rows degrades data parallelism 16 -> 16-k and the
  global batch either shrinks proportionally or is preserved via more
  gradient-accumulation microbatches (the launcher picks).

:func:`elastic_remesh_plan` and :class:`RemeshPlan` are the reference's
pure planning, copied as they are.  :func:`reshard_tree` moves a tree onto
the new mesh: each rank keeps the blocks the parameter shardings assign it
there (``launch/sharding.py``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_shape: tuple
    new_shape: tuple
    axis_names: tuple
    lost_devices: int
    microbatch_scale: int     # extra grad-accumulation to keep global batch

    @property
    def new_device_count(self) -> int:
        n = 1
        for s in self.new_shape:
            n *= s
        return n


def elastic_remesh_plan(mesh_shape: tuple, axis_names: tuple,
                        n_failed: int, *, data_axis: str = "data",
                        keep_global_batch: bool = True) -> RemeshPlan:
    """Shrink the data axis by enough rows to cover ``n_failed`` chips."""
    shape = dict(zip(axis_names, mesh_shape))
    row = 1
    for a, s in shape.items():
        if a != data_axis:
            row *= s
    rows_lost = -(-n_failed // row)              # ceil
    if rows_lost >= shape[data_axis]:
        raise RuntimeError("not enough healthy rows to rebuild the mesh")
    new_shape = dict(shape)
    new_shape[data_axis] = shape[data_axis] - rows_lost
    scale = 1
    if keep_global_batch:
        # keep global batch by extra accumulation (rounded up)
        scale = -(-shape[data_axis] // new_shape[data_axis])
    return RemeshPlan(
        old_shape=tuple(shape[a] for a in axis_names),
        new_shape=tuple(new_shape[a] for a in axis_names),
        axis_names=axis_names,
        lost_devices=n_failed,
        microbatch_scale=scale)


def reshard_tree(tree, cfg, new_mesh, *, mesh=None, coords=None):
    """This rank's blocks on ``new_mesh`` of a tree with the parameter
    rules' layout (params or some of them, or moments under the same
    specs).

    ``tree`` holds whole leaves, or, with ``mesh`` (the DeviceMesh they
    are sharded on now), this rank's blocks there, which are all-gathered
    over that mesh first.  ``new_mesh`` is a DeviceMesh, or ``{axis:
    size}`` with the rank's ``coords`` there."""
    from repro_torch.launch.sharding import (gather_block, param_shardings,
                                             take_block)

    def walk(node, old, new):
        if isinstance(node, dict):
            return {k: walk(v, old and old[k], new[k])
                    for k, v in node.items()}
        if old is not None:
            node = gather_block(node, old, mesh)
        return take_block(node, new, new_mesh, coords)

    return walk(tree, mesh and param_shardings(cfg, mesh),
                param_shardings(cfg, new_mesh))
