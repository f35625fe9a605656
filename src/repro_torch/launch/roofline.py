"""Roofline terms under the peaks of one NVIDIA H100 SXM.

    compute term    = FLOPs            / peak_FLOP/s
    memory term     = HBM bytes        / HBM_bw
    collective term = collective bytes / link_bw

all per device.  The module also holds the card's published peaks (NVIDIA
H100 SXM data sheet, dense rates without sparsity, at the full 700 W power
limit), which ``chip_smoke.py`` reads for every kernel's bound.  A card
set below 700 W runs slower under load, so a share of these peaks is
stated beside the card's power limit.

The reference's ``collective_bytes`` parses XLA HLO text, and has no
counterpart here; :func:`mesh_collective_bytes` reads what the port
counted instead: the max
per-device ``collective_bytes`` of a
:meth:`~repro_torch.launch.mesh_exec.MeshEngine.stats` dict (the bytes its
ring shifts moved into each rank), or the bytes the halo, demand and
SpSUMMA multiplies of ``core.distributed`` / ``core.spsumma`` counted
(the HLO convention: result bytes of each collective, own shard included
for an all-gather).  :func:`from_mesh_stats` puts that term over
``NVLINK_BPS``.  The reference's ``from_compiled`` (terms from a JAX
compiled artifact) waits for the port's dry run (ROADMAP.md queue 1 item
8).
"""
from __future__ import annotations

import dataclasses
from typing import Union

#: HBM3 bytes/s
HBM_BPS = 3.35e12
#: float32 FMA outside the tensor cores, FLOP/s
FP32_FLOPS = 67e12
#: dense TF32 and bf16 tensor cores, FLOP/s
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
#: float32 products on the tensor cores that keep float32's error take three
#: TF32 products each (3xTF32: a_hi b_hi + a_hi b_lo + a_lo b_hi), so the
#: least time of float32 multiply work is set by this rate, not FP32_FLOPS
FP32_3XTF32_FLOPS = TF32_FLOPS / 3
#: NVLink 4: the data sheet's 900 GB/s is the sum of both directions over
#: all 18 links of a card; the bytes a device receives move over one
#: direction, 450 GB/s
NVLINK_BPS = 900e9 / 2


@dataclasses.dataclass
class Hardware:
    """Per-card peaks (defaults: one H100 SXM)."""
    peak_flops: float = BF16_FLOPS   # dense bf16 FLOP/s
    hbm_bw: float = HBM_BPS          # B/s
    link_bw: float = NVLINK_BPS      # B/s received per card over NVLink


@dataclasses.dataclass
class Roofline:
    """Roofline terms.  SPMD modules report PER-DEVICE quantities (verified
    empirically: cost_analysis()['flops'] of an 8-way-sharded matmul equals
    2M^3/8), so flops/bytes here are per device and the terms below divide
    by single-chip peaks.  Equivalently: global_FLOPs / (chips * peak)."""
    flops: float                     # HLO flops per device
    hbm_bytes: float                 # bytes accessed per device
    coll_bytes: float                # collective bytes per device
    n_chips: int
    hw: Hardware
    model_flops: float = 0.0         # 6*N*D-style useful flops (GLOBAL)

    @property
    def t_compute(self) -> float:
        return self.flops / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.hw.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / global HLO_FLOPs — remat/redundancy waste."""
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-flop utilization if execution hits t_bound exactly."""
        if not self.model_flops or self.t_bound == 0:
            return 0.0
        return (self.model_flops
                / (self.n_chips * self.hw.peak_flops * self.t_bound))

    def row(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "dev_gflops": self.flops / 1e9,
            "dev_hbm_gb": self.hbm_bytes / 1e9,
            "dev_coll_gb": self.coll_bytes / 1e9,
            "model_gflops": self.model_flops / 1e9,
            "useful_fraction": self.useful_fraction,
            "mfu_bound": self.mfu_bound,
        }


def mesh_collective_bytes(counted: Union[dict, list, int]) -> int:
    """Per-device collective bytes of a run the port counted.

    ``counted`` is a mesh engine's ``stats()`` dict or a multiply's
    ``comm`` dict (its ``"collective_bytes"``), or the per-rank counts
    themselves; the term is the busiest device's, since SPMD waves end
    together."""
    if isinstance(counted, dict):
        counted = counted["collective_bytes"]
    if isinstance(counted, (list, tuple)):
        return int(max(counted, default=0))
    return int(counted)


def from_mesh_stats(stats: dict, *, flops: float = 0.0,
                    hbm_bytes: float = 0.0) -> Roofline:
    """Roofline of a mesh run on H100s: the collective term from its
    counted bytes (:func:`mesh_collective_bytes`) over ``NVLINK_BPS``;
    ``flops`` and ``hbm_bytes`` per device as the caller counted them."""
    return Roofline(flops=flops, hbm_bytes=hbm_bytes,
                    coll_bytes=mesh_collective_bytes(stats),
                    n_chips=max(1, int(stats.get("n_dev") or 1)),
                    hw=Hardware())
