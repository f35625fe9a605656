"""Accuracy-scaled multiply chains: pick each tau from a target bound.

Iterative electronic-structure algorithms evaluate long products
``P = A_1 A_2 ... A_m`` where every factor multiply may truncate.  The
parameterless-truncation line of work (arXiv:1906.08148) inverts the
usual knob: the user states a *target accumulated error* for the whole
chain and the library derives each step's tau.

Error propagation.  Let ``P_k`` be the exact prefix product and
``Ptilde_k`` the computed one, ``E_k = Ptilde_k - P_k``.  Step k computes
``Ptilde_k = trunc(Ptilde_{k-1} A_k)`` with that multiply's own
worst-case truncation bound ``b_k``
(:class:`~repro_torch.core.multiply.TruncationReport`), so by
submultiplicativity (``||X A||_F <= ||X||_F ||A||_2 <= ||X||_F
||A||_F``):

.. math:: ||E_k||_F \\;\\le\\; ||E_{k-1}||_F \\, ||A_k||_F + b_k.

Unrolled: ``||E_m||_F <= sum_k b_k prod_{j>k} ||A_j||_F`` — the
**accumulated bound** the chain reports.  Every quantity on the right is
*measured* (actual report bounds, actual operand norms), so the final
``accumulated_bound`` is rigorous, not an estimate.

:class:`TauPolicy` chooses tau_k *before* each step: the remaining
headroom (target minus the already-committed, forward-amplified error)
is split evenly over the remaining steps, de-amplified by the norms of
the factors still to come, and divided by a safety factor times an
estimate of how many products will be pruned (each pruned product
contributes < tau to the bound).  Because the *actual* per-step bounds
feed back into the headroom, overshoot in one step tightens the next —
the policy adapts instead of trusting its own estimate.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.api.matrix import Matrix

__all__ = ["ChainReport", "TauPolicy", "multiply_chain"]


@dataclasses.dataclass
class TauPolicy:
    """Derives per-multiply truncation thresholds from a chain target.

    Parameters
    ----------
    target : bound on the accumulated ``||P_exact - P_computed||_F`` of
        the whole chain.
    safety : headroom divisor (> 1): the policy budgets each step at
        ``1/safety`` of its even share, so estimate error in the prune
        count rarely overruns the target.
    est_prunes : pruned-products-per-multiply estimate; the default is
        the worst case ``(n / bs)^3`` — every block product pruned, each
        contributing just under tau to the bound — which makes the
        derived taus conservative: the *accumulated* bound then stays
        below the target, not only the measured error.  Decaying
        matrices spread norms over many orders of magnitude, so even
        these taus prune substantially; pass a tighter estimate to trade
        guarantee margin for pruning.
    """
    target: float
    safety: float = 4.0
    est_prunes: Optional[int] = None

    def __post_init__(self):
        if self.target < 0.0:
            raise ValueError(f"TauPolicy: target must be >= 0, got "
                             f"{self.target!r}")
        if self.safety < 1.0:
            raise ValueError(f"TauPolicy: safety must be >= 1, got "
                             f"{self.safety!r}")

    def tau_for(self, step: int, steps: int, committed: float,
                amp_rest: Sequence[float], est_prunes: int) -> float:
        """tau for step ``step`` (0-based) of ``steps``.

        ``committed`` is the accumulated bound of the prefix already
        computed; ``amp_rest[k]`` is ``prod_{j>k} ||A_j||_F`` — the
        forward amplification of an error introduced at step k.
        """
        if self.target == 0.0:
            return 0.0
        headroom = self.target - committed * amp_rest[max(step - 1, 0)]
        if headroom <= 0.0:                 # budget spent: go exact
            return 0.0
        steps_left = steps - step
        budget = headroom / (steps_left * max(amp_rest[step], 1e-300))
        n_est = self.est_prunes if self.est_prunes is not None else est_prunes
        return budget / (self.safety * max(n_est, 1))


@dataclasses.dataclass
class ChainReport:
    """Per-step taus/bounds and the rigorous accumulated chain bound."""
    target: float                   # 0.0 when no policy was given
    taus: list = dataclasses.field(default_factory=list)
    step_bounds: list = dataclasses.field(default_factory=list)
    accumulated_bound: float = 0.0  # bound on ||P_exact - P_computed||_F
    flops: float = 0.0              # leaf flops the chain registered
    pruned_flops: float = 0.0       # leaf flops truncation avoided
    steps: int = 0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["schema"] = 1
        return d


def multiply_chain(matrices: Sequence[Matrix],
                   policy: Optional[TauPolicy] = None,
                   tau: float = 0.0) -> tuple[Matrix, ChainReport]:
    """Left-to-right product of ``matrices`` with per-step truncation.

    With a :class:`TauPolicy`, each step's tau is derived from the
    target (see module docstring) and the report's
    ``accumulated_bound <= policy.target`` holds whenever the policy's
    prune estimate was not exceeded — and is rigorous regardless, since
    it is built from the measured per-step bounds.  Without a policy,
    the fixed ``tau`` applies to every step (0.0 = exact chain).

    All operands must be plain (non-upper) matrices of one session.
    """
    ms = list(matrices)
    if len(ms) < 2:
        raise ValueError("multiply_chain: need at least two matrices")
    if any(not isinstance(m, Matrix) for m in ms):
        raise TypeError("multiply_chain: operands must be Matrix handles")
    if any(m.upper for m in ms):
        raise ValueError("multiply_chain: truncated chains need plain "
                         "(non-upper) operands")
    sess = ms[0].session
    flops0 = sess.flops
    steps = len(ms) - 1
    # forward amplification: amp_rest[k] = prod_{j>k} ||A_j||_F over the
    # *factor* list a_1..a_{steps} (a_j = ms[j]); measured norms
    norms = [math.sqrt(m.frob2()) for m in ms[1:]]
    amp_rest = [1.0] * steps
    for k in range(steps - 2, -1, -1):
        amp_rest[k] = amp_rest[k + 1] * norms[k + 1]
    grid = max(ms[0].n // ms[0].params.bs, 1)
    est_prunes = grid ** 3          # worst case: every block product pruned

    rep = ChainReport(target=policy.target if policy else 0.0)
    acc = 0.0
    p = ms[0]
    for k in range(steps):
        if policy is not None:
            tk = policy.tau_for(k, steps, acc, amp_rest, est_prunes)
        else:
            tk = tau
        p = p.multiply(ms[k + 1], tau=tk)
        b_k = p.error_bound                 # measured, not estimated
        acc = acc * norms[k] + b_k
        rep.taus.append(tk)
        rep.step_bounds.append(b_k)
        if p.truncation is not None:
            rep.pruned_flops += p.truncation.pruned_flops
    rep.accumulated_bound = acc
    rep.steps = steps
    rep.flops = sess.flops - flops0
    return p, rep
