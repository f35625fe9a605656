"""bsmm_pairs_roofline: per cent of the product's least time (its block
work counted from the inputs, at the float32 3xTF32 rate and the HBM
rate) that the bsmm_pairs kernel's device time per product reaches."""
from pbench.work import roofline_pct

#: the kernels of one bsmm_pairs launch: its run offsets and its products
NAMES = ("bsmm_pairs_kernel", "run_offsets_kernel")


def read(run):
    return roofline_pct(run, NAMES)
