"""The colour matrices the film chain reads (a frozen copy of the values in
``raw2film_tpu_torch/data.py``)."""

import numpy as np

from portbench.ref.film.config import DEFAULT_DTYPE

XYZ_TO_REC709 = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    dtype=DEFAULT_DTYPE,
)

# Display P3 (SMPTE EG 432-1 primaries, D65), XYZ -> linear P3.
XYZ_TO_DISPLAY_P3 = np.array(
    [
        [2.493496911941425, -0.9313836179191239, -0.40271078445071684],
        [-0.8294889695615747, 1.7626640603183463, 0.023624685841943577],
        [0.03584583024378447, -0.07617238926804182, 0.9568845240076872],
    ],
    dtype=DEFAULT_DTYPE,
)
