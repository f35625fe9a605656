"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000, head_dim=128,
    n_experts=8, top_k=2, swa_window=4096, rope_theta=1000000.0,
    norm="rmsnorm", mlp="swiglu",
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, n_experts=4, top_k=2, moe_capacity_factor=8.0, swa_window=32, dtype="float32")
