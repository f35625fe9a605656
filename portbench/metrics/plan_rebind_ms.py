"""plan_rebind_ms: milliseconds per product in which ``Plan.run`` copies
the rebound values into the plan's inputs: the self time of the
program's ``plan.rebind`` spans in the window."""
from pbench import spans


def read(run):
    t = spans.program_self(run, "plan.rebind")
    return t * 1e3 if t else None
