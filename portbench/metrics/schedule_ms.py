"""schedule_ms: milliseconds per product in the engine's drain loop
around its waves (grouping ready tasks into waves, retiring them): the
self time of the program's ``engine.flush`` and ``engine.wave`` spans
in the window."""
from pbench import spans


def read(run):
    t = [spans.program_self(run, n) for n in ("engine.flush", "engine.wave")]
    if t == [None, None]:
        return None
    return sum(x or 0.0 for x in t) * 1e3
