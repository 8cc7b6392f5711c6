"""heom_coupling_roofline.steps: the edge-major coupling kernel
(``coupling_kernel`` of csrc/heom_coupling.cu, unbatched calls) against
its roofline."""
from harness.readers import coupling_roofline


def read(ctx):
    return coupling_roofline(ctx, r"\bcoupling_kernel\b")
