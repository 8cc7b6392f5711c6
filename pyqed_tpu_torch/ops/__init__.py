"""Operator algebra (PyTorch): the names of ``pyqed_tpu.ops`` whose
modules are ported. ``fft``, ``quadrature`` (the Gauss-Hermite module),
``jointdiag`` and ``ode`` are not yet ported (ROADMAP.md queue 1 item 6);
the hand-written kernels live in ``ops.kernels``."""
from .linalg import (
    dag, dagger, commutator, comm, anticommutator, anticomm, tensor,
    tensor_power, ptrace, transform, basis_transform, obs, obs_dm, expect,
    overlap, ket2dm, norm, rk4, isherm, isunitary, isdiag, project, sort_eig,
    eigh, eig_asymm, lindbladian, ldo,
)
from .operators import (
    pauli, sigmax, sigmay, sigmaz, sigmam, sigmap, destroy, create, basis,
    coh_op, jump, ham_ho, boson, quadrature, position, momentum, num,
    thermal_dm, spin_ops, multispin, multiboson, multimode, delta,
    displace, coherent, coherent_dm,
)
from .math import (
    lorentzian, gaussian, coth, heaviside, fermi, sinc, rect, interval,
    stepsize, fftfreq, morse, pdf_normal, discretize, cartesian_product,
    meshgrid, cartesian, logarithmic_discretize, polar2cartesian,
    cartesian2polar, polar, square_barrier, nlargest, get_index,
    polarization_vector, rotate,
)
from .superoperator import (
    dm2vec, vec2dm, vec2mat, operator_to_vector, left, right,
    operator_to_superoperator, op2sop, to_super, lindblad_dissipator, kraus,
    liouvillian, liouvillian_action, lindbladian_action, obs_vec, trace_vec,
    resolvent,
)
from .wavepacket import gwp, rgwp, gwp_k, gwp2
from .expm import (
    expm_eig, expm_herm, propagators, expm_multiply_taylor,
    krylov_expm_multiply, expm,
)
from .davidson import davidson, block_davidson
