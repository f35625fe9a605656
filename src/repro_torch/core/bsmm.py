"""Output structure of a block-sparse product (torch).

The port of the structure half of ``repro/core/bsmm.py``:
:func:`compute_c_structure` and :func:`compute_c_structure_norms` number
the occupied blocks of ``C = A @ B`` from the operands' block occupancy
alone — the one-shot equivalent of the create-from-ids task tree.  The
engine's ``validate_structure`` cross-check uses them.  The rest of the
reference module (the capacity-bounded multiply under jit) belongs to the
multi-GPU slice and is not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch


def _structure_from_occupancy(mc: torch.Tensor, cap_c: int
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor]:
    """Row-major slot numbering of an occupancy matrix (shared helper).

    Returns ``(crows, ccols, cslot, count)``: the first ``count`` entries
    of ``crows``/``ccols`` are the occupied blocks in row-major order, the
    rest (up to ``cap_c``) are filled with ``g``; ``cslot`` is the
    ``(g + 1, g + 1)`` map from a block to its slot, -1 where empty.
    """
    g = mc.shape[0]
    nz = torch.nonzero(mc)[:cap_c].to(torch.int32)     # row-major order
    crows = torch.full((cap_c,), g, dtype=torch.int32, device=mc.device)
    ccols = torch.full((cap_c,), g, dtype=torch.int32, device=mc.device)
    crows[:len(nz)] = nz[:, 0]
    ccols[:len(nz)] = nz[:, 1]
    cslot = torch.full((g + 1, g + 1), -1, dtype=torch.int32,
                       device=mc.device)
    cslot[nz[:, 0].long(), nz[:, 1].long()] = torch.arange(
        len(nz), dtype=torch.int32, device=mc.device)
    return crows, ccols, cslot, mc.sum().to(torch.int32)


def compute_c_structure(mask_a: torch.Tensor, mask_b: torch.Tensor,
                        cap_c: int) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor, torch.Tensor]:
    """Occupancy of C = A @ B: rows, cols, slot map, count.

    The boolean matmul is the one-shot equivalent of the create-from-ids
    task tree: it tells us which C blocks exist before any flop is spent.
    It runs as a float32 product (exact for the counts of any grid below
    2**24 blocks a side) so that it works on every device.
    """
    mc = (mask_a.float() @ mask_b.float()) > 0
    return _structure_from_occupancy(mc, cap_c)


def compute_c_structure_norms(norm_a: torch.Tensor, norm_b: torch.Tensor,
                              tau: float, cap_c: int
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor]:
    """Norm-weighted occupancy of C = A @ B under SpAMM truncation.

    ``norm_a[i, k]`` / ``norm_b[k, j]`` are per-block Frobenius norms
    (0 for structurally absent blocks).  Block C[i, j] survives iff some
    inner index k satisfies ``norm_a[i, k] * norm_b[k, j] >= tau`` — a
    max-times ("tropical") matmul replacing the boolean one.  ``tau <= 0``
    delegates to the exact :func:`compute_c_structure` on the nonzero
    masks (the ``>= tau`` test would otherwise mark every cell occupied,
    absent blocks included).
    """
    if tau <= 0.0:
        return compute_c_structure(norm_a > 0, norm_b > 0, cap_c)
    best = (norm_a[:, :, None] * norm_b[None, :, :]).amax(dim=1)
    mc = best >= tau
    return _structure_from_occupancy(mc, cap_c)
