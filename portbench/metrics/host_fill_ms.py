"""host_fill_ms: milliseconds per product in the engine's host fills (the
adds of partial products, transposes and scales, on the host): the self
time of the program's ``engine.host_fill`` spans in the window."""
from pbench import spans


def read(run):
    t = spans.program_self(run, "engine.host_fill")
    return t * 1e3 if t else None
