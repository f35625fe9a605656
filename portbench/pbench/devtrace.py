"""What the profiler saw on the device, reduced to numbers.

The window is traced with ``torch.profiler`` and CUDA activity only (no
host op is recorded, so the host, which sets the pace here, is slowed
less).  A one-element add on the card opens and closes the window; the
device is idle at both, so they run as the host reaches them and tie the
device's clock to the host's.  The arithmetic is a frozen copy of the
program's ``chip_smoke.py::device_idle``: busy time is the union of the
kernel, memcpy and memset intervals, and the idle share is one minus busy
over the window.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

#: the profiler's categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceTrace:
    """Device events of one traced window, in seconds on the host's clock
    (``time.perf_counter``).  ``events``: (name, category, start, end),
    sorted by start, the two marker kernels left out."""
    events: list
    t0: float
    t1: float

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list:
        """The union of the events' intervals, clipped to the window."""
        out: list = []
        for _, _, a, b in self.events:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def gaps(self) -> list:
        """The idle intervals (start, end) between busy ones, the window's
        edges included."""
        out, end = [], self.t0
        for a, b in self.busy_intervals():
            if a > end:
                out.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            out.append((end, self.t1))
        return out

    def kernel_s(self, names=None) -> float:
        """Summed device time of the kernels whose name holds one of
        ``names`` (every kernel with None)."""
        return sum(b - a for n, cat, a, b in self.events
                   if cat == "kernel"
                   and (names is None or any(k in n for k in names)))

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device operations (by name) that took the most time."""
        tot: dict = {}
        for n, _, a, b in self.events:
            tot[n] = tot.get(n, 0.0) + (b - a)
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:k]


def from_chrome_events(raw: list, host_mark: float) -> DeviceTrace:
    """Reduce a chrome trace's events to a :class:`DeviceTrace`.

    The first and the last kernel of the trace are the markers;
    ``host_mark`` is the host's clock just before it launched the first.
    The device's timestamps (us) are moved onto the host's clock by it:
    the first marker's start is taken as its launch."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                  e.get("name", ""), e["cat"]) for e in raw
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    kernels = [i for i, e in enumerate(dev) if e[3] == "kernel"]
    if len(kernels) < 2:
        raise RuntimeError(f"the profiler saw {len(kernels)} kernels in the "
                           f"window: no device trace to read")
    first, last = kernels[0], kernels[-1]
    off = host_mark - dev[first][0] / 1e6
    t0 = dev[first][1] / 1e6 + off
    t1 = dev[last][0] / 1e6 + off
    events = [(n, cat, a / 1e6 + off, b / 1e6 + off)
              for i, (a, b, n, cat) in enumerate(dev)
              if i not in (first, last)]
    return DeviceTrace(events, t0, t1)


class Window:
    """Profile the enclosed block: ``with Window(torch) as w: ...``, then
    ``w.trace`` is its :class:`DeviceTrace`."""

    def __init__(self, torch):
        self.torch = torch
        self.trace = None

    def _mark(self) -> float:
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        self._one.add_(1)
        self.torch.cuda.synchronize()
        return t

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._one = self.torch.zeros(1, device="cuda")
        self.torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._h0 = self._mark()
        return self

    def __exit__(self, *exc):
        self._mark()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.trace = from_chrome_events(raw, self._h0)
        return False
