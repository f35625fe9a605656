"""repro_torch: the PyTorch/CUDA port of ``repro``, the locality-aware
block-sparse matmul in the Chunks and Tasks model.

Public API: the :class:`Session`/:class:`Matrix` facade (``repro_torch.api``)
— operator-overloaded quadtree matrices over one context object — with the
leaf engine ``engine="torch"``, whose batched leaf multiply runs as
hand-written CUDA kernels on the GPU.  The LM substrate (``models``,
``configs``, ``launch.lm_serve``) runs the dense attention family, its
sliding-window attention through the ``banded_attention`` kernel.  The
subsystems remain importable directly (``repro_torch.core``,
``repro_torch.kernels``, ...).

The package imports ``torch`` and numpy, never ``jax`` and never the
reference package ``repro``.  Imports are lazy (PEP 562) so ``import
repro_torch`` stays cheap.
"""

__all__ = ["Session", "Matrix", "Plan", "PlanStructureError",
           "api", "configs", "core", "kernels", "launch", "models", "obs"]

_SUBPACKAGES = ("api", "configs", "core", "kernels", "launch", "models", "obs")


def __getattr__(name):
    if name in ("Session", "Matrix", "Plan", "PlanStructureError"):
        from repro_torch import api
        return getattr(api, name)
    if name in _SUBPACKAGES:
        import importlib
        return importlib.import_module(f"repro_torch.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
