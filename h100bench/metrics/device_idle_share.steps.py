"""device_idle_share.steps: % of the traced window with the device idle."""
from harness.readers import device_idle_share as read  # noqa: F401
