"""prune_ms: milliseconds per product in which a truncated multiply's
leaf tasks tested their block pairs' norm products against tau: the
program's counter ``trunc.test_s`` over the window, from each test's
first norm lookup to its kept list, on the program's clock that leaves
the collector out.  None where the program keeps no such counter."""
from pbench import spans


def read(run):
    t = spans.program_counter(run, "trunc.test_s")
    return t / run.products * 1e3 if t else None
