"""Atomic-unit conversion constants.

Same values as ``pyqed_tpu/units.py`` (bit-identical to the pyqed
reference table), so both packages convert the same way.
"""

au2fs = 2.41888432651e-2  # femtoseconds
au2as = 24.1888432651  # attoseconds
au2k = 315775.13  # Kelvin
au2ev = 27.2116

au2tesla = 2.35051756758e5
tesla = 1 / au2tesla

au2kev = 27.2116e-3
au2mev = 27.2116e3

au2wn = au2wavenumber = 219474.6305

wavenumber2hartree = wavenum2au = 4.55633525277e-06
ev2wavenumber = 8065.73

au2debye = 2.541765  # hbar^2/(m_e * e)
au2amu = 5.4857990e-4  # electron mass in unified atomic mass units
amu_to_au = amu2au = 1822.888486217313

au2nm = bohr2nanometer = 0.0529177249
au2angstrom = bohr2angstrom = 0.529177249

ev2nm = electronvolt2nanometer = 1239.84193

fine_structure = alpha = 0.0072973525693

eps0 = epsilon_0 = 8.85418781762e-12  # F/m
c0 = speed_of_light = 299792458.0  # m/s
imp0 = 376.730313668  # impedance of free space, Ohm

au2volt_per_meter = 5.14220674763e11
au2volt_per_angstrom = 51.4220674763

au2watt_per_centimeter_squared = 3.50944758e16
au2watt_per_meter_squared = 3.50944758e20
ghz2ev = 4.1357e-6
ghz2mev = 4.1357e-3

electronvolt = 1 / au2ev
wavenumber = 1 / au2wavenumber
kelvin = 1 / au2k
attosecond = 1 / au2as
femtosecond = 1 / au2fs

# Per-element average atomic masses (amu), keyed by upper-case symbol
# (reference: pyqed/units.py:51-79).
atomic_mass = {
    'H': 1.008, 'HE': 4.003, 'LI': 6.941, 'BE': 9.012,
    'B': 10.811, 'C': 12.011, 'N': 14.007, 'O': 15.999,
    'F': 18.998, 'NE': 20.180, 'NA': 22.990, 'MG': 24.305,
    'AL': 26.982, 'SI': 28.086, 'P': 30.974, 'S': 32.066,
    'CL': 35.453, 'AR': 39.948, 'K': 39.098, 'CA': 40.078,
    'SC': 44.956, 'TI': 47.867, 'V': 50.942, 'CR': 51.996,
    'MN': 54.938, 'FE': 55.845, 'CO': 58.933, 'NI': 58.693,
    'CU': 63.546, 'ZN': 65.38, 'GA': 69.723, 'GE': 72.631,
    'AS': 74.922, 'SE': 78.971, 'BR': 79.904, 'KR': 84.798,
    'RB': 84.468, 'SR': 87.62, 'Y': 88.906, 'ZR': 91.224,
    'NB': 92.906, 'MO': 95.95, 'TC': 98.907, 'RU': 101.07,
    'RH': 102.906, 'PD': 106.42, 'AG': 107.868, 'CD': 112.414,
    'IN': 114.818, 'SN': 118.711, 'SB': 121.760, 'TE': 126.7,
    'I': 126.904, 'XE': 131.294, 'CS': 132.905, 'BA': 137.328,
    'LA': 138.905, 'CE': 140.116, 'PR': 140.908, 'ND': 144.243,
    'PM': 144.913, 'SM': 150.36, 'EU': 151.964, 'GD': 157.25,
    'TB': 158.925, 'DY': 162.500, 'HO': 164.930, 'ER': 167.259,
    'TM': 168.934, 'YB': 173.055, 'LU': 174.967, 'HF': 178.49,
    'TA': 180.948, 'W': 183.84, 'RE': 186.207, 'OS': 190.23,
    'IR': 192.217, 'PT': 195.085, 'AU': 196.967, 'HG': 200.592,
    'TL': 204.383, 'PB': 207.2, 'BI': 208.980, 'PO': 208.982,
    'AT': 209.987, 'RN': 222.081, 'FR': 223.020, 'RA': 226.025,
    'AC': 227.028, 'TH': 232.038, 'PA': 231.036, 'U': 238.029,
    'NP': 237, 'PU': 244, 'AM': 243, 'CM': 247, 'BK': 247,
    'CT': 251, 'ES': 252, 'FM': 257, 'MD': 258, 'NO': 259,
    'LR': 262, 'RF': 261, 'DB': 262, 'SG': 266, 'BH': 264,
    'HS': 269, 'MT': 268, 'DS': 271, 'RG': 272, 'CN': 285,
    'NH': 284, 'FL': 289, 'MC': 288, 'LV': 292, 'TS': 294,
    'OG': 294,
}


class AtomicUnits:
    """Named atomic-unit constants (as ``pyqed_tpu.units.AtomicUnits``)."""

    def __init__(self):
        self.ev = au2ev
        self.fs = au2fs
        self.wavenumber = au2wavenumber
        self.kelvin = au2k
