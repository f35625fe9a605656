"""Hand-written CUDA kernels (Hopper) for the leaf engine, with plain versions.

batched_gemm — the leaf engine's batched GEMM (paper §4.1 / Table 2)
bsmm_pairs   — fused gather-GEMM-scatter over surviving block pairs

Call them through :mod:`repro_torch.kernels.ops`, which dispatches by
device; the submodules of the same names launch the kernels.  Sources are
in ``repro_torch/csrc``; :mod:`._build` compiles them at first use.
``banded_attention`` is not ported yet (ROADMAP.md, queue 2).
"""
