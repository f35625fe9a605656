"""recurse_ms: milliseconds per product in the task programs' recursion:
the self time of the program's root ``qt.*`` spans (``qt.multiply``,
``qt.sym_square``, ...) less the pair lists and C structures built
inside them (each span's ``pairs_s``, less that of a root span nested in
it)."""
from pbench import spans


def read(run):
    roots = [(t, at["pairs_s"], sid, parent)
             for _, t, at, sid, parent in spans.program_spans(run) or ()
             if "pairs_s" in at]
    if not roots:
        return None
    nested: dict = {}
    for _, p, _, parent in roots:
        nested[parent] = nested.get(parent, 0.0) + p
    t = sum(t - (p - nested.get(sid, 0.0)) for t, p, sid, _ in roots)
    return t / run.products * 1e3
