"""maps_per_min: see harness/readers.py."""
from harness.readers import maps_per_min as read  # noqa: F401
