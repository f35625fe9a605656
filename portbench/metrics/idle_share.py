"""idle_share: per cent of the traced window in which the device ran no
kernel, copy or memset (the largest over the cell's chips)."""


def read(run):
    if not run.traces:
        return None
    return 100.0 * max(t.idle_share for t in run.traces)
