"""C = A B of two general matrices (``Matrix.__matmul__``)."""

OPERANDS = ("A", "B")


def call(m):
    return m["A"] @ m["B"]


def reference_operands(blocks):
    """The reference's left and right factors, from each operand's
    blocks (:class:`pbench.reference.BlockMatrix`)."""
    return blocks["A"], blocks["B"]
