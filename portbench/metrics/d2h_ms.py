"""d2h_ms: milliseconds per product in the copy of each wave's C to the
host and the synchronize it ends with (the kernel runs inside it): the
self time of the program's ``copy.d2h`` spans in the window."""
from pbench import spans


def read(run):
    t = spans.program_self(run, "copy.d2h")
    return t * 1e3 if t else None
