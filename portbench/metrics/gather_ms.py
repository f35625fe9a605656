"""gather_ms: milliseconds per product in the engine's gather of its waves
(slot numbering, the pair arrays, the stacked operands, the sort by C
slot): the self time of the program's ``engine.gather`` spans in the
window."""
from pbench import spans


def read(run):
    t = spans.program_self(run, "engine.gather")
    return t * 1e3 if t else None
