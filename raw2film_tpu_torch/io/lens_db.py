"""Curated lens-profile database: common lenses, approximate corrections.

Role of lensfun's camera/lens database in the reference (reference:
src/raw2film/effects.py:22-43, utils.py:24-79). Like the film stocks in
``film/loader.py``, these are ORIGINAL approximate characterizations
authored from public optical knowledge (lens class, focal range, aperture),
not copied calibration data: kit zooms run ~2-4% barrel at the wide end
drifting to slight pincushion at the long end, wide primes ~1-2% barrel,
normal primes well under 1%, fast lenses lose 1-1.5 EV in the corners wide
open and most of it by f/8. Real lensfun XML can always be imported on top
with ``raw2film-tpu --import-lensfun`` (io/lensfun_convert.py) and takes
precedence by list order in ``find_profile``.

Distortion: poly3, scale = k1*r^2 + (1 - k1) with r normalized to the
half-diagonal (k1 < 0 corrects barrel). Vignetting rows:
(focal, aperture, k1, k2, k3) of the `pa` polynomial.
"""

from __future__ import annotations

from raw2film_tpu_torch.io.lens import LensProfile


def _vig(focal: float, f_open: float, strength: float = 1.0):
    """Wide-open + stopped-down vignetting rows for one focal length."""
    return (
        (focal, f_open, -1.05 * strength, 0.30 * strength, -0.08 * strength),
        (focal, f_open * 2.4, -0.38 * strength, 0.08 * strength, 0.0),
        (focal, 11.0, -0.16 * strength, 0.03 * strength, 0.0),
    )


def _prime(make, model, focal, f_open, k1, crop=1.0, vig_strength=1.0,
           confidence="curated"):
    return LensProfile(
        make=make,
        model=model,
        crop_factor=crop,
        dist_model="poly3",
        dist_params=((focal, k1),),
        vig_params=_vig(focal, f_open, vig_strength),
        confidence=confidence,
    )


def _zoom(make, model, wide, tele, f_wide, f_tele, k1_wide, k1_tele,
          crop=1.0, vig_strength=1.0, k1_mid=None, confidence="curated"):
    mid = (wide + tele) / 2.0
    if k1_mid is None:
        k1_mid = 0.25 * k1_wide + 0.75 * k1_tele  # distortion flips early
    return LensProfile(
        make=make,
        model=model,
        crop_factor=crop,
        dist_model="poly3",
        dist_params=((wide, k1_wide), (mid, k1_mid), (tele, k1_tele)),
        vig_params=_vig(wide, f_wide, vig_strength)
        + _vig(tele, f_tele, vig_strength),
        confidence=confidence,
    )


PROFILES: list[LensProfile] = [
    # ---------------------------------------------------------- Canon EF/RF
    _zoom("Canon", "EF24-105mm f/4L", 24, 105, 4.0, 4.0, -0.030, 0.012),
    _zoom("Canon", "EF24-70mm f/2.8L", 24, 70, 2.8, 2.8, -0.026, 0.010),
    _zoom("Canon", "EF16-35mm f/4L", 16, 35, 4.0, 4.0, -0.034, 0.004),
    _zoom("Canon", "EF70-200mm f/2.8L", 70, 200, 2.8, 2.8, 0.003, 0.010, vig_strength=0.8),
    _zoom("Canon", "EF-S18-55mm", 18, 55, 3.5, 5.6, -0.036, 0.010, crop=1.6),
    _zoom("Canon", "EF-S18-135mm", 18, 135, 3.5, 5.6, -0.038, 0.012, crop=1.6),
    _prime("Canon", "EF50mm f/1.8", 50, 1.8, -0.007),
    _prime("Canon", "EF50mm f/1.4", 50, 1.4, -0.006),
    _prime("Canon", "EF35mm f/2", 35, 2.0, -0.011),
    _prime("Canon", "EF85mm f/1.8", 85, 1.8, 0.003),
    _zoom("Canon", "RF24-105mm F4 L", 24, 105, 4.0, 4.0, -0.042, 0.014),
    _zoom("Canon", "RF24-70mm F2.8 L", 24, 70, 2.8, 2.8, -0.034, 0.010),
    _prime("Canon", "RF50mm F1.8", 50, 1.8, -0.014),
    _prime("Canon", "RF16mm F2.8", 16, 2.8, -0.075, vig_strength=1.3),
    # -------------------------------------------------------------- Nikon F/Z
    _zoom("Nikon", "AF-S NIKKOR 24-70mm f/2.8", 24, 70, 2.8, 2.8, -0.024, 0.010),
    _zoom("Nikon", "AF-S NIKKOR 24-120mm f/4", 24, 120, 4.0, 4.0, -0.032, 0.013),
    _zoom("Nikon", "AF-S NIKKOR 14-24mm f/2.8", 14, 24, 2.8, 2.8, -0.028, 0.002),
    _zoom("Nikon", "AF-S DX NIKKOR 18-55mm", 18, 55, 3.5, 5.6, -0.035, 0.009, crop=1.5),
    _zoom("Nikon", "AF-S DX NIKKOR 18-140mm", 18, 140, 3.5, 5.6, -0.037, 0.012, crop=1.5),
    _prime("Nikon", "AF-S NIKKOR 50mm f/1.8", 50, 1.8, -0.009),
    _prime("Nikon", "AF-S NIKKOR 35mm f/1.8", 35, 1.8, -0.013),
    _prime("Nikon", "AF-S NIKKOR 85mm f/1.8", 85, 1.8, 0.002),
    _zoom("Nikon", "NIKKOR Z 24-70mm f/4", 24, 70, 4.0, 4.0, -0.036, 0.010),
    _prime("Nikon", "NIKKOR Z 50mm f/1.8", 50, 1.8, -0.006),
    _zoom("Nikon", "NIKKOR Z 24-120mm f/4", 24, 120, 4.0, 4.0, -0.038, 0.013),
    # ------------------------------------------------------------------ Sony
    _zoom("Sony", "FE 24-70mm F2.8 GM", 24, 70, 2.8, 2.8, -0.028, 0.010),
    _zoom("Sony", "FE 24-105mm F4 G", 24, 105, 4.0, 4.0, -0.040, 0.013),
    _zoom("Sony", "FE 16-35mm F2.8 GM", 16, 35, 2.8, 2.8, -0.033, 0.004),
    _zoom("Sony", "FE 28-70mm F3.5-5.6 OSS", 28, 70, 3.5, 5.6, -0.022, 0.009),
    _prime("Sony", "FE 55mm F1.8 ZA", 55, 1.8, -0.005),
    _prime("Sony", "FE 50mm F1.8", 50, 1.8, -0.008),
    _prime("Sony", "FE 85mm F1.8", 85, 1.8, 0.002),
    _prime("Sony", "FE 35mm F1.8", 35, 1.8, -0.012),
    _zoom("Sony", "E 18-55mm F3.5-5.6 OSS", 18, 55, 3.5, 5.6, -0.033, 0.009, crop=1.5),
    _zoom("Sony", "E PZ 16-50mm", 16, 50, 3.5, 5.6, -0.060, 0.008, crop=1.5, vig_strength=1.2),
    # -------------------------------------------------------------- Fujifilm
    _zoom("Fujifilm", "XF18-55mm", 18, 55, 2.8, 4.0, -0.028, 0.008, crop=1.5),
    _zoom("Fujifilm", "XF16-80mm", 16, 80, 4.0, 4.0, -0.038, 0.011, crop=1.5),
    _zoom("Fujifilm", "XF10-24mm", 10, 24, 4.0, 4.0, -0.030, 0.003, crop=1.5),
    _prime("Fujifilm", "XF35mm", 35, 1.4, -0.006, crop=1.5),
    _prime("Fujifilm", "XF23mm", 23, 1.4, -0.012, crop=1.5),
    _prime("Fujifilm", "XF56mm", 56, 1.2, 0.002, crop=1.5),
    # ------------------------------------------------------- Micro four thirds
    _zoom("Panasonic", "LUMIX G VARIO 12-60", 12, 60, 3.5, 5.6, -0.030, 0.009, crop=2.0),
    _prime("Panasonic", "LUMIX G 25", 25, 1.7, -0.008, crop=2.0),
    _zoom("Olympus", "M.12-40mm F2.8", 12, 40, 2.8, 2.8, -0.026, 0.008, crop=2.0),
    _zoom("Olympus", "M.14-42mm", 14, 42, 3.5, 5.6, -0.032, 0.008, crop=2.0),
    _prime("Canon", "RF35mm F1.8", 35, 1.8, -0.022),
    _prime("Canon", "RF50mm F1.2 L", 50, 1.2, -0.006, vig_strength=1.2),
    _prime("Canon", "EF85mm f/1.2", 85, 1.2, 0.002, vig_strength=1.2),
    _zoom("Canon", "EF16-35mm f/2.8L", 16, 35, 2.8, 2.8, -0.032, 0.004),
    _prime("Nikon", "NIKKOR Z 35mm f/1.8", 35, 1.8, -0.010),
    _prime("Nikon", "NIKKOR Z 85mm f/1.8", 85, 1.8, 0.002),
    _prime("Sony", "FE 20mm F1.8 G", 20, 1.8, -0.028, vig_strength=1.2),
    _prime("Sony", "FE 85mm F1.4 GM", 85, 1.4, 0.002, vig_strength=1.1),
    _zoom("Fujifilm", "XF16-55mm", 16, 55, 2.8, 2.8, -0.026, 0.008, crop=1.5),
    _prime("Olympus", "M.45mm F1.8", 45, 1.8, 0.001, crop=2.0),
    # ----------------------------------------------------------- Sigma/Tamron
    _prime("Sigma", "35mm F1.4 DG", 35, 1.4, -0.010),
    _prime("Sigma", "50mm F1.4 DG", 50, 1.4, -0.006),
    _zoom("Sigma", "18-35mm F1.8 DC", 18, 35, 1.8, 1.8, -0.019, 0.004, crop=1.5),
    _zoom("Tamron", "28-75mm F/2.8", 28, 75, 2.8, 2.8, -0.024, 0.010),
    _zoom("Tamron", "17-28mm F/2.8", 17, 28, 2.8, 2.8, -0.026, 0.002),
    _zoom("Tamron", "SP 24-70mm F/2.8", 24, 70, 2.8, 2.8, -0.026, 0.010),
]
