"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (MHA kv=32) d_ff=10240
vocab=32000, ssm_state=64; Mamba2 backbone + ONE shared attention block
applied every 6 layers (zamba2-style shared transformer block).
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000, head_dim=80,
    mixer="mamba2", ssm_state=64, ssm_head_dim=64, d_conv=4, expand=2,
    attn_every=6, norm="rmsnorm", mlp="swiglu",
    rope_theta=10000.0,
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    head_dim=16, ssm_state=8, ssm_head_dim=16, attn_every=2,
    dtype="float32")
