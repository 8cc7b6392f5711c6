"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates), at
its full power limit of 700 W."""

# FP64 on the tensor cores (DMMA); FP32 outside them is the same rate
FLOPS = 67e12
# HBM3
BYTES_PER_S = 3.35e12


def least_seconds(flops, nbytes):
    """The least time of a piece of work on the card: its operations at
    the peak rate or its bytes at the peak bandwidth, the larger."""
    return max(flops / FLOPS, nbytes / BYTES_PER_S)
