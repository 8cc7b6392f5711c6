from .result import Result, load_result
from .dynamics import (run_solver, propagate, rk4_step, rk4_step_t,
                       expect_ket, expect_dm)
from . import diagnostics
