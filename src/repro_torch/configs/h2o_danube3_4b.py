"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000; llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense", n_layers=24, d_model=3840,
    n_heads=32, n_kv_heads=8, d_ff=10240, vocab=32000, head_dim=120,
    swa_window=4096, rope_theta=10000.0, norm="rmsnorm", mlp="swiglu",
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, swa_window=32, dtype="float32")
