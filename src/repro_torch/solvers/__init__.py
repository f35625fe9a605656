"""Electronic-structure solver suite over the quadtree matrix library.

The paper's block-sparse multiply exists to serve linear-scaling
electronic structure: congruence transformations, inverse factorization
of the overlap matrix and density-matrix purification, all running on
hierarchical matrix structures with error-controlled truncation.  This
package composes those workloads from the library's task programs:

* :mod:`~repro_torch.solvers.inverse_factor` — recursive, localized and
  global-refinement inverse factorization ``Z^T S Z = I``
  (arXiv:1901.07993) with a typed :class:`FactorReport`.
* :mod:`~repro_torch.solvers.chains` — accuracy-scaled multiply chains: a
  :class:`TauPolicy` picks per-multiply truncation thresholds from a
  target accumulated error bound (arXiv:1906.08148).
* :mod:`~repro_torch.solvers.scf` — the full density-matrix pipeline
  S → Z → Z^T F Z → SP2 purification → D, compiled to rebindable
  plans so per-iteration structure drift exercises
  ``plan.run(recompile=True)`` successor caching.
"""
from .chains import ChainReport, TauPolicy, multiply_chain
from .inverse_factor import FactorReport, inverse_factor
from .scf import SCFReport, scf_density

__all__ = ["ChainReport", "FactorReport", "SCFReport", "TauPolicy",
           "inverse_factor", "multiply_chain", "scf_density"]
