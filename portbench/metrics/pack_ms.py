"""pack_ms: milliseconds per product in ``Session.flush()`` outside the
program's ``kernel.dispatch`` spans: the engine's grouping of waves and
its packing and unpacking of blocks on the host (and, on a mesh, its
planning of the shipments)."""
from pbench import spans


def read(run):
    t = spans.self_time(run.spans, "flush", spans.DISPATCH)
    return t / run.products * 1e3 if t > 0 else None
