"""Global configuration constants.

Mirrors the role of the reference's ``spectral_film_lut.config``
(reference: src/raw2film/raw_conversion.py:10 imports DEFAULT_DTYPE).
"""

import numpy as np

DEFAULT_DTYPE = np.float32
"""Pipeline float dtype for host-side LUT construction and the device chain."""

LOG_EXPOSURE_MIN = -4.0
"""Lower edge of the log10-relative-exposure grid for H&D curves."""

LOG_EXPOSURE_MAX = 2.0
"""Upper edge of the log10-relative-exposure grid for H&D curves."""

DENSITY_CURVE_SIZE = 512
"""Samples in a 1D H&D density curve LUT."""

INPUT_LUT_SIZE = 128
"""Side length of the 2D chromaticity input LUT."""

PRINT_LUT_SIZE = 33
"""Side length of the 3D print/output LUT."""

LINEAR_SCALING = 4.0
"""Density-domain scale baked into the 3D LUT: LUT coords = density / 4
(reference: src/raw2film/cpu_processor.py:251 ``linear_scaling=4.0`` and
cpu_processor.py:405 ``apply_lut_tetrahedral(image, lut, 0.25)``)."""

LOG10_EPS = 1e-6
"""Clip floor before log10 (reference: shaders/lut_1d.wgsl safe_log10_vec3)."""
