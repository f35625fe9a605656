"""Cross-session plan cache: compile a request shape once, serve forever.

A :class:`~repro_torch.api.plan.Plan` is cached per
:class:`~repro_torch.api.session.Session` under a key that includes the
*identity* of its bound inputs — the right contract for a single user,
but a serving front end sees the same request shape arrive against many
different matrices and many sessions.  The :class:`SharedPlanCache`
groups plans by their input-identity-free ``struct_key`` (the
:func:`repro_torch.api.expr.fingerprint` of expression shape + tau +
QTParams + operand quadtree structures): any replica compiled anywhere in
the server can serve any request with that structure, because every
serving run rebinds **all** input slots with the request's effective
values (DESIGN.md §9).

Registration is push-based: :meth:`attach` hooks a session's
``_plan_observers`` list, so every plan that session compiles — including
the successors ``plan.run(..., recompile=True)`` creates after a
structure-mismatch rebind — lands here without the server having to know
where compiles happen.
"""
from __future__ import annotations

from repro_torch.api.lru import LRUCache
from repro_torch.obs.metrics import MetricSet

__all__ = ["SharedPlanCache"]


class SharedPlanCache:
    """``struct_key`` -> list of Plan replicas, across serving sessions.

    Replica count per key is naturally bounded by the number of sessions:
    a session that already holds a plan for the (struct, inputs) pair
    returns it from its own cache instead of compiling a twin, so
    :meth:`attach`-observed registrations only ever add one replica per
    (session, template-inputs) combination.  The key space itself is
    LRU-bounded by ``cap``.
    """

    def __init__(self, cap: int = 128):
        self._by_struct: LRUCache = LRUCache(cap=cap)

    # -- wiring ---------------------------------------------------------------
    def attach(self, session) -> None:
        """Observe every plan ``session`` compiles from now on."""
        session._plan_observers.append(self.register)

    def register(self, plan) -> None:
        """Add a freshly compiled plan as a replica of its struct_key."""
        replicas = self._by_struct.peek(plan.struct_key)
        if replicas is None:
            replicas = []
            self._by_struct.put(plan.struct_key, replicas)
        if plan not in replicas:
            replicas.append(plan)

    # -- lookup ---------------------------------------------------------------
    def lookup(self, struct_key: str) -> list:
        """All replicas for a structure (LRU-touching; counts hit/miss)."""
        return self._by_struct.get(struct_key) or []

    def __len__(self) -> int:
        return len(self._by_struct)

    @property
    def n_replicas(self) -> int:
        return sum(len(r) for r in self._by_struct.values())

    # -- reporting ------------------------------------------------------------
    def counters(self) -> dict:
        c = self._by_struct.counters()
        c["replicas"] = self.n_replicas
        return c

    def metrics(self) -> MetricSet:
        ms = MetricSet(source="serve-cache")
        for k in ("hits", "misses", "evictions", "size", "replicas"):
            ms.add(f"shared_cache_{k}", "count", [self.counters()[k]])
        return ms

    def __repr__(self) -> str:
        return (f"SharedPlanCache(keys={len(self)}, "
                f"replicas={self.n_replicas}, "
                f"hits={self._by_struct.hits}, "
                f"misses={self._by_struct.misses})")
