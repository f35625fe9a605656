"""comm_mb: MB (1e6 bytes) per product that the busiest rank fetched and
moved in collectives, from the mesh engine's own per-rank counters over
the window (the paper's Table 1 quantity)."""


def read(run):
    if not run.counters:
        return None
    c = run.counters[0]     # each rank holds every rank's counters
    per_rank = [f + x for f, x in zip(c["fetched_bytes"],
                                      c["collective_bytes"])]
    return max(per_rank) / run.products / 1e6
