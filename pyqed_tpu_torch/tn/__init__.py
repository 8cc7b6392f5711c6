"""Tensor networks (PyTorch): the names of ``pyqed_tpu.tn`` — MPS/MPO,
two-site DMRG, TEBD, one- and two-site TDVP, autoMPO, the ab initio
MPOs (``DMRGQC`` itself raises until ``qchem`` is ported), TT-LDR, the
vibronic MPS and tensor trains — with ``mps_from_reference`` and
``mpo_from_reference``, which carry a JAX MPS or MPO across as NumPy
arrays."""
from .mps import (
    MPS, MPO, DMRG, two_site_dmrg, tebd, apply_mpo, MatrixProductState,
    mpo_nearest_neighbor, mpo_tfim, mpo_heisenberg,
    mps_from_reference, mpo_from_reference,
)
from .tdvp import TDVP, TDVP2
from .autompo import (autoMPO, autompo_fermion, hubbard_mpo,
                      spinful_to_sites, DMRGElectronicDVR)
from .chemps import (mpo_from_product_terms, qc_mpo, spin_orbital_terms,
                     number_mpo, DMRGQC)
from .vibronic import VibronicMPS, lvc_mpo
from .ttals import tt_svd, tt_als, tt_to_dense, tt_eval, tt_rank
from .ttspo import (TT_LDR, tt_compress, tt_norm, tt_inner, hadamard_apply,
                    mpo_apply)
from .ncon import ncon
