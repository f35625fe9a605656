"""register_ms: milliseconds per product in the operator call (``A @ B``,
``S.sym_square()``): the task programs register the product's structure
and leave the numeric work to the engine.  The benchmark's ``register``
span, summed over the window, over the products."""
from pbench import spans


def read(run):
    t = spans.total(run.spans, "register")
    return t / run.products * 1e3 if t > 0 else None
