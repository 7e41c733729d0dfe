"""Physical constants and unit conversions.

Unit system (identical to the reference engine, see
the reference's glob_v.f90:386-390):

  length   : Angstrom
  time     : ps
  mass     : g/mol
  energy   : kJ/mol
  charge   : elementary charge e

Velocities are A/ps, forces kJ/mol/A.
"""

import numpy as np

# e^2/Angstrom -> kJ/mol   (glob_v.f90:389)
CONV_E2A_KJMOL = 1389.35465

# kJ/mol -> A^2/ps^2 * g/mol   (glob_v.f90:388)
CONV_KJMOL_A2PS2GMOL = 100.0

# Boltzmann constant, kJ/mol/K   (glob_v.f90:390)
KB = 0.008314462

PI = np.pi
SQRT_PI = np.sqrt(np.pi)

# MS-EVB hop-search threshold DEFAULTS (glob_v.f90:54-55).  These are
# compile-time constants in the reference; here they are runtime sim keys
# (evb_first_solvation_cutoff / evb_reactive_pair_distance in the sim .pmt,
# carried on System) and these module constants are only the defaults.
EVB_FIRST_SOLVATION_CUTOFF = 5.0     # Angstrom, COM-COM
EVB_REACTIVE_PAIR_DISTANCE = 2.5     # Angstrom, H .. acceptor atom

# bar -> kJ/mol/A^3 (md_integration.f90:255)
CONV_BAR_KJMOLA3 = 6.022e-5
