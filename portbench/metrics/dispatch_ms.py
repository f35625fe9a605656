"""dispatch_ms: milliseconds per product in the program's
``kernel.dispatch`` spans inside a flush: the copies to the card, the
launch, the copy back and a synchronize (on a mesh also the ring shifts
and the all-gather of C)."""
from pbench import spans


def read(run):
    t = spans.within(run.spans, spans.DISPATCH, "flush")
    return t / run.products * 1e3 if t > 0 else None
