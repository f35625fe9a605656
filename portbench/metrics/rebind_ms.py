"""rebind_ms: milliseconds per product in ``Plan.run(..., flush=False)``:
the copy of the new values into the plan's inputs and the replay's
bookkeeping (the tasks deferred again).  The benchmark's ``rebind`` span,
summed over the window, over the products."""
from pbench import spans


def read(run):
    t = spans.total(run.spans, "rebind")
    return t / run.products * 1e3 if t > 0 else None
