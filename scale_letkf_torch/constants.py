"""Physical constants of the port.

The port's own copy of the values in scale_letkf_tpu/constants.py that it
uses (reference: common/common.f90:28-40 and the SCALE constant module
conventions behind common_scale.f90 state_trans), so thermodynamic
transforms agree numerically with the reference; tests/test_torch_config.py
holds the two sets equal.
"""

from __future__ import annotations

import numpy as np

# Earth / geometry
RE = 6.371e6          # earth radius [m]            (common/common.f90: re)
GRAV = 9.81           # gravity [m/s^2]             (common/common.f90: gg)
D2R = np.pi / 180.0
R2D = 180.0 / np.pi

# Dry air / vapor thermodynamics (SCALE CONST module conventions)
RD = 287.04           # gas constant dry air [J/kg/K]     (CONST_Rdry)
RV = 461.50           # gas constant water vapor [J/kg/K] (CONST_Rvap)
CVDRY = 717.60        # specific heat dry air, const volume [J/kg/K] (CONST_CVdry)
PRE00 = 1.0e5         # reference pressure [Pa]           (CONST_PRE00)
T00 = 273.15

# Water category specific heats (const volume), SCALE TRACER_CV for the
# Tomita08 6-category set (qv, qc, qr, qi, qs, qg): vapour CV_vapor,
# liquid CL, ice CI (common_scale.f90:1181 state_trans moist CVtot sum)
CV_VAPOR = 1390.0     # CONST_CVvap
CL_WATER = 4218.0     # CONST_CL
CI_ICE = 2106.0       # CONST_CI
TRACER_CV = np.array([CV_VAPOR, CL_WATER, CL_WATER, CI_ICE, CI_ICE, CI_ICE])

# Virtual temperature factor (common/common.f90: fvirt)
FVIRT = RV / RD - 1.0

# Saturation vapour pressure over liquid water (Tetens)
PSAT0 = 610.78        # [Pa] at T00
TETENS_A_LIQ = 17.269
TETENS_B_LIQ = 35.86
