"""h2d_ms: milliseconds per product in the copies of each wave's operands
and pair arrays to the card (pinning included): the self time of the
program's ``copy.h2d`` spans in the window."""
from pbench import spans


def read(run):
    t = spans.program_self(run, "copy.h2d")
    return t * 1e3 if t else None
