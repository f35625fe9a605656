"""hubert-xlarge [audio] — 48L d_model=1280 16H (MHA) d_ff=5120 vocab=504;
encoder-only (bidirectional), gelu MLP; the conv waveform frontend is a
STUB (input_specs supplies precomputed frame embeddings).
[arXiv:2106.07447; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504, head_dim=80,
    causal=False, frontend="frames", norm="rmsnorm", mlp="gelu",
    tie_embeddings=False, rope_theta=10000.0,
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=64,
    head_dim=16, dtype="float32")
