from .floquet import (
    TightBinding, FloquetBloch, floquet_matrix, make_peierls_blocks_fn,
    gomez_leon_model, Floquet,
    floquet_states, floquet_evolution,
)
from .free_electron import light_driven_free_electron, cep_scan, efield
