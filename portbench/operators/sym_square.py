"""C = S S of a symmetric matrix in upper storage (``Matrix.sym_square``),
C's upper blocks."""

OPERANDS = ("S",)


def call(m):
    return m["S"].sym_square()


def reference_operands(blocks):
    return blocks["S"], blocks["S"]
