"""step_mfu.steps: the whole RK4 step's share of the card's peak."""
from harness.readers import step_mfu as read  # noqa: F401
