"""C = X X truncated by SpAMM's norm test (``Matrix.multiply(tau=TAU)``):
the program drops every product, of subtrees or of ``bs x bs`` blocks,
whose operands' Frobenius norms multiply to less than TAU.  A dropped
subtree product holds only block pairs below TAU, so the reference keeps
exactly the block pairs whose norm product reaches TAU."""
import numpy as np

TAU = 3.5e-4
#: relative distance from TAU within which the reference does not decide
#: a pair: the program's and the reference's float64 sums may order the
#: same squares differently (about 1e-16 apart)
BRACKET = 1e-9
OPERANDS = ("X",)


def call(m):
    return m["X"].multiply(m["X"], tau=TAU)


def reference_operands(blocks):
    return blocks["X"], blocks["X"]


def reference_pairs(blocks, cfg, ia, ib):
    """Keep pair (ia, ib) iff sqrt(|A_ia|^2 |B_ib|^2) >= TAU, the squared
    norms summed in float64 over the values the program holds: the
    harness builds X from float64 values, which the program keeps on the
    host (only the kernel's operands are float32)."""
    a, b = reference_operands(blocks)
    na = (a.blocks ** 2).sum(axis=(1, 2))
    nb = (b.blocks ** 2).sum(axis=(1, 2))
    bound = np.sqrt(na[ia] * nb[ib])
    near = np.abs(bound - TAU) <= BRACKET * TAU
    if near.any():
        raise ValueError(f"{int(near.sum())} block pair(s) with a norm "
                         f"product within {BRACKET} of tau (relative): "
                         f"the reference cannot decide them")
    return bound >= TAU
