"""The plain reference that decides a cell's ``correct``.

Plain NumPy and PyTorch, written from the equations: the Drude bath's
Padé decomposition (:mod:`.bath`), the hierarchy and its neighbours
(:mod:`.hierarchy`), the HEOM right-hand side and RK4 (:mod:`.heom`) and
the explicit-field phase-cycled 2DES (:mod:`.field2des`). It imports
nothing of the measured program and takes nothing the program made: the
benchmark hands it the same plain inputs (Hamiltonian, bath parameters,
pulses, initial states) that it hands the program.
"""
