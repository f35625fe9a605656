"""falcon-mamba-7b [ssm] — 64L d_model=4096 attention-free d_ff=0
vocab=65024, ssm_state=16 (Mamba1 architecture). [arXiv:2410.05355;
unverified]

Arch-applicability note (DESIGN.md): the paper's attention/banded
block-sparse technique does not apply to the attention-free mixer; the
SSM scan is the mixer. Included per instructions."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=65024, mixer="mamba1",
    ssm_state=16, d_conv=4, expand=2, norm="rmsnorm",
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=32, vocab=128, ssm_state=4, dtype="float32")
