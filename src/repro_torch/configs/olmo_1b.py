"""olmo-1b [dense] — 16L d_model=2048 16H (GQA kv=16 == MHA) d_ff=8192
vocab=50304; non-parametric LayerNorm. [arXiv:2402.00838; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=8192, vocab=50304, head_dim=128,
    rope_theta=10000.0, norm="nonparam_ln", mlp="swiglu",
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    head_dim=16, dtype="float32")
