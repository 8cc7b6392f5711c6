"""Neural-network PES fitting (PyTorch), with the names of
``pyqed_tpu.ml``."""
from .nn import MLP, init_params, forward, mse, params_from_numpy
