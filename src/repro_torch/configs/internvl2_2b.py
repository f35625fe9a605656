"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553; InternViT frontend is a STUB (input_specs supplies
precomputed patch embeddings), InternLM2-style LM backbone.
[arXiv:2404.16821; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab=92553, head_dim=128,
    frontend="patches", n_patches=256, rope_theta=1000000.0,
    norm="rmsnorm", mlp="swiglu",
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, n_patches=8, dtype="float32")
