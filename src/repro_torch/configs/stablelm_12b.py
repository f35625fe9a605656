"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2-1_6b family; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=13824, vocab=100352, head_dim=160,
    rope_theta=10000.0, norm="rmsnorm", mlp="swiglu",
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab=256,
    head_dim=16, dtype="float32")
