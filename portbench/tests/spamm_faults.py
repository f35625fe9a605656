"""Faults planted under the truncated square's timed path
(``main.run(..., plant="spamm_faults:<name>")``), beside those of
``portbench_faults.py`` (``tau_zero``, ``tf32_operands``), which the
truncated square's tests plant too."""
from portbench_faults import _patch_tau


def tau_one_percent_high():
    """Every truncated multiply of the program run at 1.01 tau: it drops
    the block pairs whose norm product lies in [tau, 1.01 tau)."""
    _patch_tau(lambda tau: 1.01 * tau)
