"""heom_coupling_roofline.maps: the destination-major coupling kernel on
DMMA (``coupling_dm_dmma_kernel`` of csrc/heom_coupling.cu, batched
calls) against its roofline."""
from harness.readers import coupling_roofline


def read(ctx):
    return coupling_roofline(ctx, r"\bcoupling_dm_dmma_kernel\b")
