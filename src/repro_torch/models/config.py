"""Model configuration — one frozen dataclass covers all 10 assigned
architectures (dense / MoE / SSM / hybrid / audio / VLM LM-family).

The per-arch configs live in ``repro_torch/configs/<id>.py``; this module
defines the schema and the four assigned input shapes.  A copy of the
reference's ``repro/models/config.py`` with ``jdtype`` replaced by
``torch_dtype``; ``input_specs`` returns :class:`InputSpec` named tuples
(shape, torch dtype, batch-axis spec) where the reference returns
``jax.ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # attention flavour
    swa_window: int = 0          # 0 = full attention; else sliding window
    causal: bool = True          # False = encoder-only (hubert)
    rope_theta: float = 500000.0
    norm: str = "rmsnorm"        # rmsnorm | nonparam_ln
    mlp: str = "swiglu"          # swiglu | gelu
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    # SSM
    mixer: str = "attention"     # attention | mamba1 | mamba2
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2              # d_inner = expand * d_model
    ssm_head_dim: int = 64       # mamba2 head dim
    # hybrid (zamba2-style): one shared attention block every attn_every
    attn_every: int = 0
    # modality frontend (audio/vlm): stub supplies embeddings directly
    frontend: str = "tokens"     # tokens | frames | patches
    n_patches: int = 256         # vlm: patch embeddings per image
    dtype: str = "bfloat16"
    # cost mode: the reference's dry-run switch; here it only picks the
    # larger attention chunks of the reference's cost mode
    cost_mode: bool = False

    # -- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, self.d_model // 16)

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def attention_free(self) -> bool:
        return self.mixer == "mamba1"

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced config for smoke tests (same family, tiny dims)."""
        return dataclasses.replace(self, **kw)

    # -- parameter count (for 6ND roofline bookkeeping) ----------------------
    def param_count(self) -> int:
        d, ff, L, v = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        emb = v * d
        per_layer = 0
        if self.mixer == "attention" or self.family == "hybrid":
            attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        else:
            attn = 0
        if self.mlp == "swiglu":
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        if self.mixer == "attention":
            if self.n_experts:
                per_layer = attn + d * self.n_experts + self.n_experts * mlp
            else:
                per_layer = attn + mlp
        elif self.mixer == "mamba1":
            di, st, dr = self.d_inner, self.ssm_state, self.dt_rank
            per_layer = (d * 2 * di + di * self.d_conv
                         + di * (dr + 2 * st) + dr * di + di * st + di
                         + di * d)
        elif self.mixer == "mamba2":
            # hybrid: per-layer MLP lives in the shared block, not here
            di, st = self.d_inner, self.ssm_state
            nh_ssm = self.n_ssm_heads
            proj_in = d * (2 * di + 2 * st + nh_ssm)
            per_layer = (proj_in + (di + 2 * st) * self.d_conv
                         + nh_ssm * 2 + di * d + di)
        total = emb + L * per_layer
        if self.family == "hybrid" and self.attn_every:
            # one shared attention block (+MLP), applied repeatedly
            total += (d * nh * hd + 2 * d * nkv * hd + nh * hd * d
                      + 3 * d * ff)
        if not self.tie_embeddings:
            total += v * d
        return total

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6*N_active*D)."""
        if not self.n_experts:
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        mlp = 3 * d * ff if self.mlp == "swiglu" else 2 * d * ff
        dense = self.param_count() - L * self.n_experts * mlp
        return dense + L * self.top_k * mlp


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape (see task brief)."""
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeSpec("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def applicable_shapes(cfg: ModelConfig) -> list[ShapeSpec]:
    """Principled skips (DESIGN.md §Arch-applicability):

    * encoder-only archs have no decode step -> skip decode shapes;
    * ``long_500k`` needs sub-quadratic attention -> run only for SSM /
      hybrid / SWA archs.
    """
    out = [TRAIN_4K, PREFILL_32K]
    if not cfg.is_encoder_only:
        out.append(DECODE_32K)
        if cfg.mixer in ("mamba1", "mamba2") or cfg.swa_window:
            out.append(LONG_500K)
    return out


class InputSpec(NamedTuple):
    """Stand-in for one model input: no allocation.  ``spec`` is the
    partition spec of the input's dims over mesh axis names (the batch
    dim's entry first), or ``None`` when no sharding was asked for."""
    shape: tuple
    dtype: torch.dtype
    spec: Optional[tuple] = None


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                batch_spec: Optional[tuple] = None) -> dict:
    """An :class:`InputSpec` for every model input (no allocation).

    train:   {tokens, targets} (or frames/patches for stub frontends)
    prefill: {tokens}
    decode:  the new-token batch only, as in the reference.

    Frames and patches are bfloat16 whatever the config's type, token
    fields int32; a patches prefill has no ``targets``.  ``batch_spec``
    (for example ``(("pod", "data"),)``) is every field's spec.
    """
    b, s = shape.global_batch, shape.seq_len

    def arr(shp, dt=torch.int32):
        return InputSpec(shp, dt, batch_spec)

    if cfg.frontend == "frames" and shape.kind in ("train", "prefill"):
        return {
            "frames": arr((b, s, cfg.d_model), torch.bfloat16),
            "targets": arr((b, s)),
        }
    if cfg.frontend == "patches":
        s_text = s - cfg.n_patches
        base = {
            "tokens": arr((b, s_text)),
            "patches": arr((b, cfg.n_patches, cfg.d_model), torch.bfloat16),
        }
        if shape.kind == "train":
            base["targets"] = arr((b, s_text))
        return base
    base = {"tokens": arr((b, s))}
    if shape.kind == "train":
        base["targets"] = arr((b, s))
    return base
