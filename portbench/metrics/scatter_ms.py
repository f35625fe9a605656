"""scatter_ms: milliseconds per product in the engine's scatter of each
wave's C blocks into their leaves: the self time of the program's
``engine.scatter`` spans in the window."""
from pbench import spans


def read(run):
    t = spans.program_self(run, "engine.scatter")
    return t * 1e3 if t else None
