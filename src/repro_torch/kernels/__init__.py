"""Hand-written CUDA kernels (Hopper), each with its plain PyTorch version.

batched_gemm    — the leaf engine's batched GEMM (paper §4.1 / Table 2)
bsmm_pairs      — fused gather-GEMM-scatter over surviving block pairs
block_attention — banded (sliding-window) flash attention, the LM's
                  ``windowed_attention`` (``banded_attention``)
block_attention_bwd — its gradient, for training (``banded_attention_bwd``)

Call them through :mod:`repro_torch.kernels.ops`, which dispatches by
device; the submodules of the same names launch the kernels.  Sources are
in ``repro_torch/csrc``; :mod:`._build` compiles them at first use.
"""
