"""Meshes, the distributed runtime and the pencil FFT on
``torch.distributed`` (counterpart of ``pyqed_tpu/parallel``)."""
from .mesh import make_mesh, shard_along, replicated, with_sharding, pad_to_multiple
from .distributed import ensure_distributed, process_info, global_mesh
from .pencil_fft import (pencil_supported, fft_sharded, ifft_sharded,
                         make_keo_pencil, make_keo_factors_pencil)
