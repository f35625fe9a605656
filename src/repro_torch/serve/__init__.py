"""Plan-serving subsystem (DESIGN.md §9).

Concurrent multiply / SP2-purification requests over a pool of lazy
sessions: bounded admission, a cross-session plan cache keyed by
structural fingerprint, and a cross-plan wave coalescer that merges the
in-flight plans' ready leaf waves into shared ``bsmm_pairs`` launches on
the card.

>>> from repro_torch.serve import PlanServer, Request    # doctest: +SKIP
>>> srv = PlanServer(n_sessions=2, max_inflight=4)       # doctest: +SKIP
>>> srv.register("A", a); srv.register("B", b)           # doctest: +SKIP
>>> t = srv.submit(Request.multiply("A", "B"))           # doctest: +SKIP
>>> srv.drain(); t.result                                # doctest: +SKIP

``PlanServer()`` serves on the CUDA device and raises without one;
``PlanServer(device="cpu")`` runs the kernels' plain PyTorch versions.
"""
from .cache import SharedPlanCache
from .coalesce import WaveCoalescer
from .server import (AdmissionError, PlanServer, Request, ServeConfig,
                     Ticket)

__all__ = ["AdmissionError", "PlanServer", "Request", "ServeConfig",
           "SharedPlanCache", "Ticket", "WaveCoalescer"]
