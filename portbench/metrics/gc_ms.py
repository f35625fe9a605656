"""gc_ms: milliseconds per product in which the interpreter's cyclic
collector ran: the program's counter ``gc.collect_s`` over the window."""
from pbench import spans


def read(run):
    t = spans.program_counter(run, "gc.collect_s")
    return t / run.products * 1e3 if t else None
