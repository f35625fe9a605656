"""batched_gemm_roofline: per cent of the product's least time on the
cell's chips (its block work counted from the inputs, at the float32
3xTF32 rate and the HBM rate of each chip) that the batched_gemm kernel's
device time per product, averaged over the chips, reaches."""
from pbench.work import roofline_pct

NAMES = ("batched_gemm_kernel",)


def read(run):
    return roofline_pct(run, NAMES)
