"""pairs_ms: milliseconds per product in which the engine built each
leaf task's pair list and C structure (at registration, and at a plan's
replay): the program's counter ``engine.pairs_s`` over the window, timed
on the program's clock that leaves the collector out."""
from pbench import spans


def read(run):
    t = spans.program_counter(run, "engine.pairs_s")
    return t / run.products * 1e3 if t else None
