"""kernels_per_step.maps: device operations launched in the traced window per
RK4 step, the host's work per step."""
from harness.readers import kernels_per_step as read  # noqa: F401
