"""steps_per_s: see harness/readers.py."""
from harness.readers import steps_per_s as read  # noqa: F401
