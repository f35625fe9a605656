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
counterpart here: the port compiles no program to parse, and its
collectives count their own bytes where they are called
(``core.distributed.CommStats``).  :func:`mesh_collective_bytes` reads
what the mesh multiply counted: the max per-device ``collective_bytes``
of a :meth:`~repro_torch.launch.mesh_exec.MeshEngine.stats` dict (the
bytes its ring shifts moved into each rank), or the bytes the halo,
demand and SpSUMMA multiplies of ``core.distributed`` / ``core.spsumma``
counted (the HLO convention: result bytes of each collective, own shard
included for an all-gather).  :func:`from_mesh_stats` puts that term over
``NVLINK_BPS``.  :func:`from_counted`, the counterpart of the reference's
``from_compiled``, takes the terms of one rank's step as the dry run
(``launch/dryrun.py``) counted them.  :func:`kernel_work` gives each
hand-written kernel's FLOPs and bytes, for the smoke's bounds and the dry
run's count.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np

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
#: HBM3 capacity of one card, bytes (80 GB)
HBM_BYTES = 80e9


@dataclasses.dataclass
class Hardware:
    """Per-card peaks (defaults: one H100 SXM)."""
    peak_flops: float = BF16_FLOPS   # dense bf16 FLOP/s
    hbm_bw: float = HBM_BPS          # B/s
    link_bw: float = NVLINK_BPS      # B/s received per card over NVLink
    hbm_bytes: float = HBM_BYTES     # device memory per card, bytes


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


def from_counted(costs: dict, n_chips: int, hw: Hardware = None,
                 model_flops: float = 0.0) -> Roofline:
    """Roofline of one rank's counted step (``launch/dryrun.py``): the
    ``flops``, ``hbm`` and ``coll`` of ``costs`` per device, the
    counterpart of the reference's ``from_compiled``."""
    return Roofline(flops=costs["flops"], hbm_bytes=costs["hbm"],
                    coll_bytes=costs["coll"], n_chips=n_chips,
                    hw=hw or Hardware(), model_flops=model_flops)


# ---------------------------------------------------------------------------
# the work of each hand-written kernel: the least it must compute and move
# ---------------------------------------------------------------------------

def band_pairs(s: int, window: int, causal: bool) -> int:
    """(query, key) pairs inside the band of an S x S score matrix."""
    i = np.arange(s, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0)
    hi = i if causal else np.minimum(i + window - 1, s - 1)
    return int((hi - lo + 1).sum())


def kernel_work(kernel: str, **shape) -> tuple:
    """``(flops, bytes)`` of one call of ``kernel`` (a name of
    ``kernels/_build.py``'s ``KERNELS``): the operations its inputs need
    and the bytes it must move, each input read once and each output
    written once.  The bound of a kernel's time is the larger of bytes over
    ``HBM_BPS`` and FLOPs over the peak of its type.

    * ``block_attention`` / ``block_attention_bwd``: ``heads``,
      ``kv_heads``, ``seq``, ``head_dim``, ``window``, ``causal``,
      ``itemsize`` — the forward does q kᵀ and p v over the band's pairs
      (4 d pairs h), reads q, k, v and writes o; the backward does q kᵀ,
      do vᵀ, dS k, Pᵀ do and dSᵀ q (10 d pairs h), reads q, do, k, v and
      writes dq, dk, dv;
    * ``bsmm_pairs``: ``a_blocks``, ``b_blocks``, ``c_blocks`` (the
      blocks it reads and writes), ``bs``, ``pairs``, ``valid_pairs``,
      ``itemsize`` — 2 bs³ a valid pair, the blocks once each and three
      int32 per pair;
    * ``batched_gemm``: ``products``, ``bs``, ``itemsize`` — 2 bs³ a
      product, A, B read and C written once.
    """
    if kernel in ("block_attention", "block_attention_bwd"):
        h, d, elt = shape["heads"], shape["head_dim"], shape["itemsize"]
        q = h * shape["seq"] * d
        kv = shape["kv_heads"] * shape["seq"] * d
        pairs = band_pairs(shape["seq"], shape["window"], shape["causal"])
        if kernel == "block_attention":
            return 4.0 * d * pairs * h, (2 * q + 2 * kv) * elt
        return 5 * 2.0 * d * pairs * h, (3 * q + 4 * kv) * elt
    if kernel == "bsmm_pairs":
        bs = shape["bs"]
        blocks = shape["a_blocks"] + shape["b_blocks"] + shape["c_blocks"]
        return (2.0 * bs ** 3 * shape["valid_pairs"],
                blocks * bs * bs * shape["itemsize"] + 3 * 4 * shape["pairs"])
    if kernel == "batched_gemm":
        p, bs = shape["products"], shape["bs"]
        return 2.0 * bs ** 3 * p, 3 * p * bs * bs * shape["itemsize"]
    raise ValueError(f"kernel_work: unknown kernel {kernel!r}")
