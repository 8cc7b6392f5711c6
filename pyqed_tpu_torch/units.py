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
