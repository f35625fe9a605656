"""The import guard: nothing the benchmark runs may load JAX or the JAX
package (``repro``).  Module names are compared by their top-level name,
the part before the first dot, whole: ``repro_torch`` is the program
under test and passes, ``repro`` and ``repro.core`` do not."""
from __future__ import annotations

import sys

#: top-level module names that may not be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
