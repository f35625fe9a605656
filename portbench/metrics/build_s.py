"""build_s: seconds to build one input quadtree from the benchmark's
coordinates through ``Session.from_pattern`` (``qt_from_coo``), timed in
set-up: the mean over the cell's inputs, the slowest rank's on a mesh."""


def read(run):
    return max(run.build_s) if run.build_s else None
