"""mfu: per cent of the chips' peak that the whole product reaches: its
useful operations (2 bs^3 per structural block pair, counted from the
inputs) over the traced run's seconds per product times the float32
(3xTF32) peak of the chips the cell uses."""
from pbench.work import FP32_3XTF32_FLOPS


def read(run):
    return 100.0 * run.work.flops / (run.product_s * FP32_3XTF32_FLOPS
                                     * run.chips)
