"""device_idle_share.maps: % of the traced window with the device idle."""
from harness.readers import device_idle_share as read  # noqa: F401
