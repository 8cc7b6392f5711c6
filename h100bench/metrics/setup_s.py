"""setup_s: see harness/readers.py."""
from harness.readers import setup_s as read  # noqa: F401
