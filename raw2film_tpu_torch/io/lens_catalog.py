"""Extended lens catalog: real lens models with class-derived corrections.

Closes the out-of-the-box matching gap against the reference, which loads
the full lensfun database (reference: src/raw2film/gui.py:556-563,
utils.py:24-79 loose EXIF matching over thousands of lenses). The public
lensfun XML corpus cannot be fetched in this zero-egress build, so this
catalog takes the VERDICT's alternate route: VENDOR a wide catalog of real,
currently-and-recently-sold lens models (names, focal ranges, apertures and
mount crop factors are public catalog facts) with corrections DERIVED from
lens-class heuristics — the same authoring approach as the curated
``lens_db.PROFILES`` (kit zooms ~3-4% barrel wide drifting to slight
pincushion long, ultra-wides more, normal primes well under 1%, fast glass
~1-1.5 EV corner falloff wide open). Class-derived numbers are approximate;
measured lensfun XML imported via ``raw2film-tpu --import-lensfun`` always
takes precedence (it is prepended by the importer, and ``find_profile``
scans in list order).

Row format: ``(make, model, wide, tele, f_wide, f_tele, crop)`` — primes
carry ``tele=None``/``f_tele=None``. Fisheyes are deliberately absent (the
poly3 rectilinear model does not apply). Budget manual primes carry the
maker inside the model string: their engraved spec ('35mm F1.4') is exactly
the generic string a contactless manual lens would leave in EXIF, and the
wrong-model guard must keep such files unmatched (they are selected through
the viewer's manual lens override instead).
"""

from __future__ import annotations

from functools import lru_cache


def _k1_prime(focal_eq: float, name: str) -> float:
    if "acro" in name:  # Macro/Makro: engineered for near-zero distortion
        return -0.001
    if focal_eq <= 15:
        return -0.045
    if focal_eq <= 20:
        return -0.030
    if focal_eq <= 28:
        return -0.016
    if focal_eq <= 38:
        return -0.011
    if focal_eq <= 68:
        return -0.006
    if focal_eq <= 135:
        return 0.002
    return 0.003


def _k1_zoom_wide(wide_eq: float, ratio: float, fast: bool) -> float:
    if wide_eq >= 50:  # tele zoom: mild pincushion throughout
        return 0.003
    if ratio >= 7:  # superzoom
        return -0.045
    if wide_eq <= 13:
        return -0.028
    if wide_eq <= 17:
        return -0.032
    if wide_eq <= 20:
        return -0.034
    if wide_eq <= 26:
        return -0.030 if fast else -0.038
    return -0.024


def _k1_zoom_tele(tele_eq: float, ratio: float) -> float:
    if tele_eq <= 40:
        return 0.003
    if ratio >= 7:
        return 0.014
    return 0.010 if tele_eq <= 250 else 0.012


# (make, model, wide, tele, f_wide, f_tele, crop)
_ROWS = [
    # ------------------------------------------------------------- Canon EF
    ("Canon", "EF 14mm f/2.8L II USM", 14, None, 2.8, None, 1.0),
    ("Canon", "EF 20mm f/2.8 USM", 20, None, 2.8, None, 1.0),
    ("Canon", "EF 24mm f/1.4L II USM", 24, None, 1.4, None, 1.0),
    ("Canon", "EF 24mm f/2.8 IS USM", 24, None, 2.8, None, 1.0),
    ("Canon", "EF 28mm f/1.8 USM", 28, None, 1.8, None, 1.0),
    ("Canon", "EF 28mm f/2.8 IS USM", 28, None, 2.8, None, 1.0),
    ("Canon", "EF 35mm f/1.4L II USM", 35, None, 1.4, None, 1.0),
    ("Canon", "EF 35mm f/2 IS USM", 35, None, 2.0, None, 1.0),
    ("Canon", "EF 40mm f/2.8 STM", 40, None, 2.8, None, 1.0),
    ("Canon", "EF 50mm f/1.2L USM", 50, None, 1.2, None, 1.0),
    ("Canon", "EF 50mm f/1.8 II", 50, None, 1.8, None, 1.0),
    ("Canon", "EF 85mm f/1.4L IS USM", 85, None, 1.4, None, 1.0),
    ("Canon", "EF 100mm f/2 USM", 100, None, 2.0, None, 1.0),
    ("Canon", "EF 100mm f/2.8L Macro IS USM", 100, None, 2.8, None, 1.0),
    ("Canon", "EF 100mm f/2.8 Macro USM", 100, None, 2.8, None, 1.0),
    ("Canon", "EF 135mm f/2L USM", 135, None, 2.0, None, 1.0),
    ("Canon", "EF 200mm f/2.8L II USM", 200, None, 2.8, None, 1.0),
    ("Canon", "EF 300mm f/4L IS USM", 300, None, 4.0, None, 1.0),
    ("Canon", "EF 400mm f/5.6L USM", 400, None, 5.6, None, 1.0),
    ("Canon", "EF 11-24mm f/4L USM", 11, 24, 4.0, 4.0, 1.0),
    ("Canon", "EF 16-35mm f/2.8L III USM", 16, 35, 2.8, 2.8, 1.0),
    ("Canon", "EF 17-40mm f/4L USM", 17, 40, 4.0, 4.0, 1.0),
    ("Canon", "EF 24-70mm f/4L IS USM", 24, 70, 4.0, 4.0, 1.0),
    ("Canon", "EF 24-105mm f/4L IS II USM", 24, 105, 4.0, 4.0, 1.0),
    ("Canon", "EF 24-105mm f/3.5-5.6 IS STM", 24, 105, 3.5, 5.6, 1.0),
    ("Canon", "EF 28-135mm f/3.5-5.6 IS USM", 28, 135, 3.5, 5.6, 1.0),
    ("Canon", "EF 70-200mm f/2.8L IS III USM", 70, 200, 2.8, 2.8, 1.0),
    ("Canon", "EF 70-200mm f/4L IS USM", 70, 200, 4.0, 4.0, 1.0),
    ("Canon", "EF 70-300mm f/4-5.6 IS II USM", 70, 300, 4.0, 5.6, 1.0),
    ("Canon", "EF 75-300mm f/4-5.6 III", 75, 300, 4.0, 5.6, 1.0),
    ("Canon", "EF 100-400mm f/4.5-5.6L IS II USM", 100, 400, 4.5, 5.6, 1.0),
    ("Canon", "EF 28-300mm f/3.5-5.6L IS USM", 28, 300, 3.5, 5.6, 1.0),
    # ----------------------------------------------------------- Canon EF-S
    ("Canon", "EF-S 10-18mm f/4.5-5.6 IS STM", 10, 18, 4.5, 5.6, 1.6),
    ("Canon", "EF-S 10-22mm f/3.5-4.5 USM", 10, 22, 3.5, 4.5, 1.6),
    ("Canon", "EF-S 15-85mm f/3.5-5.6 IS USM", 15, 85, 3.5, 5.6, 1.6),
    ("Canon", "EF-S 17-55mm f/2.8 IS USM", 17, 55, 2.8, 2.8, 1.6),
    ("Canon", "EF-S 18-55mm f/4-5.6 IS STM", 18, 55, 4.0, 5.6, 1.6),
    ("Canon", "EF-S 18-135mm f/3.5-5.6 IS USM", 18, 135, 3.5, 5.6, 1.6),
    ("Canon", "EF-S 18-200mm f/3.5-5.6 IS", 18, 200, 3.5, 5.6, 1.6),
    ("Canon", "EF-S 55-250mm f/4-5.6 IS STM", 55, 250, 4.0, 5.6, 1.6),
    ("Canon", "EF-S 24mm f/2.8 STM", 24, None, 2.8, None, 1.6),
    ("Canon", "EF-S 35mm f/2.8 Macro IS STM", 35, None, 2.8, None, 1.6),
    # ------------------------------------------------------------- Canon RF
    ("Canon", "RF 14-35mm F4 L IS USM", 14, 35, 4.0, 4.0, 1.0),
    ("Canon", "RF 15-35mm F2.8 L IS USM", 15, 35, 2.8, 2.8, 1.0),
    ("Canon", "RF 24-105mm F4-7.1 IS STM", 24, 105, 4.0, 7.1, 1.0),
    ("Canon", "RF 24-240mm F4-6.3 IS USM", 24, 240, 4.0, 6.3, 1.0),
    ("Canon", "RF 28-70mm F2 L USM", 28, 70, 2.0, 2.0, 1.0),
    ("Canon", "RF 70-200mm F2.8 L IS USM", 70, 200, 2.8, 2.8, 1.0),
    ("Canon", "RF 70-200mm F4 L IS USM", 70, 200, 4.0, 4.0, 1.0),
    ("Canon", "RF 100-400mm F5.6-8 IS USM", 100, 400, 5.6, 8.0, 1.0),
    ("Canon", "RF 100-500mm F4.5-7.1 L IS USM", 100, 500, 4.5, 7.1, 1.0),
    ("Canon", "RF 24mm F1.8 Macro IS STM", 24, None, 1.8, None, 1.0),
    ("Canon", "RF 28mm F2.8 STM", 28, None, 2.8, None, 1.0),
    ("Canon", "RF 85mm F1.2 L USM", 85, None, 1.2, None, 1.0),
    ("Canon", "RF 85mm F2 Macro IS STM", 85, None, 2.0, None, 1.0),
    ("Canon", "RF 100mm F2.8 L Macro IS USM", 100, None, 2.8, None, 1.0),
    ("Canon", "RF 135mm F1.8 L IS USM", 135, None, 1.8, None, 1.0),
    ("Canon", "RF 600mm F11 IS STM", 600, None, 11.0, None, 1.0),
    ("Canon", "RF 800mm F11 IS STM", 800, None, 11.0, None, 1.0),
    ("Canon", "RF-S 18-45mm F4.5-6.3 IS STM", 18, 45, 4.5, 6.3, 1.6),
    ("Canon", "RF-S 18-150mm F3.5-6.3 IS STM", 18, 150, 3.5, 6.3, 1.6),
    # -------------------------------------------------------------- Nikon F
    ("Nikon", "AF NIKKOR 14mm f/2.8D ED", 14, None, 2.8, None, 1.0),
    ("Nikon", "AF-S NIKKOR 20mm f/1.8G ED", 20, None, 1.8, None, 1.0),
    ("Nikon", "AF-S NIKKOR 24mm f/1.4G ED", 24, None, 1.4, None, 1.0),
    ("Nikon", "AF-S NIKKOR 24mm f/1.8G ED", 24, None, 1.8, None, 1.0),
    ("Nikon", "AF-S NIKKOR 28mm f/1.8G", 28, None, 1.8, None, 1.0),
    ("Nikon", "AF-S NIKKOR 35mm f/1.4G", 35, None, 1.4, None, 1.0),
    ("Nikon", "AF NIKKOR 35mm f/2D", 35, None, 2.0, None, 1.0),
    ("Nikon", "AF-S NIKKOR 50mm f/1.4G", 50, None, 1.4, None, 1.0),
    ("Nikon", "AF NIKKOR 50mm f/1.8D", 50, None, 1.8, None, 1.0),
    ("Nikon", "AF-S NIKKOR 58mm f/1.4G", 58, None, 1.4, None, 1.0),
    ("Nikon", "AF-S NIKKOR 85mm f/1.4G", 85, None, 1.4, None, 1.0),
    ("Nikon", "AF-S NIKKOR 105mm f/1.4E ED", 105, None, 1.4, None, 1.0),
    ("Nikon", "AF-S VR Micro-NIKKOR 105mm f/2.8G", 105, None, 2.8, None, 1.0),
    ("Nikon", "AF DC-NIKKOR 135mm f/2D", 135, None, 2.0, None, 1.0),
    ("Nikon", "AF-S NIKKOR 300mm f/4E PF ED VR", 300, None, 4.0, None, 1.0),
    ("Nikon", "AF-S NIKKOR 16-35mm f/4G ED VR", 16, 35, 4.0, 4.0, 1.0),
    ("Nikon", "AF-S NIKKOR 17-35mm f/2.8D ED", 17, 35, 2.8, 2.8, 1.0),
    ("Nikon", "AF-S NIKKOR 18-35mm f/3.5-4.5G ED", 18, 35, 3.5, 4.5, 1.0),
    ("Nikon", "AF-S NIKKOR 24-70mm f/2.8E ED VR", 24, 70, 2.8, 2.8, 1.0),
    ("Nikon", "AF-S NIKKOR 24-85mm f/3.5-4.5G ED VR", 24, 85, 3.5, 4.5, 1.0),
    ("Nikon", "AF-S NIKKOR 28-300mm f/3.5-5.6G ED VR", 28, 300, 3.5, 5.6, 1.0),
    ("Nikon", "AF-S NIKKOR 70-200mm f/2.8E FL ED VR", 70, 200, 2.8, 2.8, 1.0),
    ("Nikon", "AF-S NIKKOR 70-200mm f/4G ED VR", 70, 200, 4.0, 4.0, 1.0),
    ("Nikon", "AF-S NIKKOR 70-300mm f/4.5-5.6G VR", 70, 300, 4.5, 5.6, 1.0),
    ("Nikon", "AF-S NIKKOR 80-400mm f/4.5-5.6G ED VR", 80, 400, 4.5, 5.6, 1.0),
    ("Nikon", "AF-S NIKKOR 200-500mm f/5.6E ED VR", 200, 500, 5.6, 5.6, 1.0),
    # ------------------------------------------------------------- Nikon DX
    ("Nikon", "AF-S DX NIKKOR 10-24mm f/3.5-4.5G ED", 10, 24, 3.5, 4.5, 1.5),
    ("Nikon", "AF-S DX NIKKOR 12-24mm f/4G ED", 12, 24, 4.0, 4.0, 1.5),
    ("Nikon", "AF-S DX NIKKOR 16-80mm f/2.8-4E ED VR", 16, 80, 2.8, 4.0, 1.5),
    ("Nikon", "AF-S DX NIKKOR 17-55mm f/2.8G ED", 17, 55, 2.8, 2.8, 1.5),
    ("Nikon", "AF-S DX NIKKOR 18-105mm f/3.5-5.6G ED VR", 18, 105, 3.5, 5.6, 1.5),
    ("Nikon", "AF-S DX NIKKOR 18-200mm f/3.5-5.6G ED VR II", 18, 200, 3.5, 5.6, 1.5),
    ("Nikon", "AF-S DX NIKKOR 18-300mm f/3.5-6.3G ED VR", 18, 300, 3.5, 6.3, 1.5),
    ("Nikon", "AF-S DX NIKKOR 55-200mm f/4-5.6G ED VR II", 55, 200, 4.0, 5.6, 1.5),
    ("Nikon", "AF-S DX NIKKOR 55-300mm f/4.5-5.6G ED VR", 55, 300, 4.5, 5.6, 1.5),
    ("Nikon", "AF-S DX NIKKOR 35mm f/1.8G", 35, None, 1.8, None, 1.5),
    ("Nikon", "AF-S DX Micro NIKKOR 40mm f/2.8G", 40, None, 2.8, None, 1.5),
    ("Nikon", "AF-S DX Micro NIKKOR 85mm f/3.5G ED VR", 85, None, 3.5, None, 1.5),
    # -------------------------------------------------------------- Nikon Z
    ("Nikon", "NIKKOR Z 14-24mm f/2.8 S", 14, 24, 2.8, 2.8, 1.0),
    ("Nikon", "NIKKOR Z 14-30mm f/4 S", 14, 30, 4.0, 4.0, 1.0),
    ("Nikon", "NIKKOR Z 17-28mm f/2.8", 17, 28, 2.8, 2.8, 1.0),
    ("Nikon", "NIKKOR Z 24-50mm f/4-6.3", 24, 50, 4.0, 6.3, 1.0),
    ("Nikon", "NIKKOR Z 24-70mm f/2.8 S", 24, 70, 2.8, 2.8, 1.0),
    ("Nikon", "NIKKOR Z 24-200mm f/4-6.3 VR", 24, 200, 4.0, 6.3, 1.0),
    ("Nikon", "NIKKOR Z 28-75mm f/2.8", 28, 75, 2.8, 2.8, 1.0),
    ("Nikon", "NIKKOR Z 70-180mm f/2.8", 70, 180, 2.8, 2.8, 1.0),
    ("Nikon", "NIKKOR Z 70-200mm f/2.8 VR S", 70, 200, 2.8, 2.8, 1.0),
    ("Nikon", "NIKKOR Z 100-400mm f/4.5-5.6 VR S", 100, 400, 4.5, 5.6, 1.0),
    ("Nikon", "NIKKOR Z 20mm f/1.8 S", 20, None, 1.8, None, 1.0),
    ("Nikon", "NIKKOR Z 24mm f/1.8 S", 24, None, 1.8, None, 1.0),
    ("Nikon", "NIKKOR Z 26mm f/2.8", 26, None, 2.8, None, 1.0),
    ("Nikon", "NIKKOR Z 28mm f/2.8", 28, None, 2.8, None, 1.0),
    ("Nikon", "NIKKOR Z 40mm f/2", 40, None, 2.0, None, 1.0),
    ("Nikon", "NIKKOR Z 50mm f/1.2 S", 50, None, 1.2, None, 1.0),
    ("Nikon", "NIKKOR Z 85mm f/1.2 S", 85, None, 1.2, None, 1.0),
    ("Nikon", "NIKKOR Z MC 105mm f/2.8 VR S", 105, None, 2.8, None, 1.0),
    ("Nikon", "NIKKOR Z 135mm f/1.8 S Plena", 135, None, 1.8, None, 1.0),
    ("Nikon", "NIKKOR Z DX 16-50mm f/3.5-6.3 VR", 16, 50, 3.5, 6.3, 1.5),
    ("Nikon", "NIKKOR Z DX 50-250mm f/4.5-6.3 VR", 50, 250, 4.5, 6.3, 1.5),
    ("Nikon", "NIKKOR Z DX 18-140mm f/3.5-6.3 VR", 18, 140, 3.5, 6.3, 1.5),
    # -------------------------------------------------------------- Sony FE
    ("Sony", "FE 12-24mm F2.8 GM", 12, 24, 2.8, 2.8, 1.0),
    ("Sony", "FE 12-24mm F4 G", 12, 24, 4.0, 4.0, 1.0),
    ("Sony", "FE 14mm F1.8 GM", 14, None, 1.8, None, 1.0),
    ("Sony", "FE 16-35mm F2.8 GM II", 16, 35, 2.8, 2.8, 1.0),
    ("Sony", "Vario-Tessar T* FE 16-35mm F4 ZA OSS", 16, 35, 4.0, 4.0, 1.0),
    ("Sony", "FE 20-70mm F4 G", 20, 70, 4.0, 4.0, 1.0),
    ("Sony", "FE 24mm F1.4 GM", 24, None, 1.4, None, 1.0),
    ("Sony", "FE 24mm F2.8 G", 24, None, 2.8, None, 1.0),
    ("Sony", "FE 24-70mm F2.8 GM II", 24, 70, 2.8, 2.8, 1.0),
    ("Sony", "Vario-Tessar T* FE 24-70mm F4 ZA OSS", 24, 70, 4.0, 4.0, 1.0),
    ("Sony", "FE 24-240mm F3.5-6.3 OSS", 24, 240, 3.5, 6.3, 1.0),
    ("Sony", "FE 28mm F2", 28, None, 2.0, None, 1.0),
    ("Sony", "FE 28-60mm F4-5.6", 28, 60, 4.0, 5.6, 1.0),
    ("Sony", "FE 35mm F1.4 GM", 35, None, 1.4, None, 1.0),
    ("Sony", "Distagon T* FE 35mm F1.4 ZA", 35, None, 1.4, None, 1.0),
    ("Sony", "Sonnar T* FE 35mm F2.8 ZA", 35, None, 2.8, None, 1.0),
    ("Sony", "FE 40mm F2.5 G", 40, None, 2.5, None, 1.0),
    ("Sony", "FE 50mm F1.2 GM", 50, None, 1.2, None, 1.0),
    ("Sony", "FE 50mm F1.4 GM", 50, None, 1.4, None, 1.0),
    ("Sony", "Planar T* FE 50mm F1.4 ZA", 50, None, 1.4, None, 1.0),
    ("Sony", "FE 50mm F2.5 G", 50, None, 2.5, None, 1.0),
    ("Sony", "FE 90mm F2.8 Macro G OSS", 90, None, 2.8, None, 1.0),
    ("Sony", "FE 100mm F2.8 STF GM OSS", 100, None, 2.8, None, 1.0),
    ("Sony", "FE 135mm F1.8 GM", 135, None, 1.8, None, 1.0),
    ("Sony", "FE 70-200mm F2.8 GM OSS II", 70, 200, 2.8, 2.8, 1.0),
    ("Sony", "FE 70-200mm F4 G OSS", 70, 200, 4.0, 4.0, 1.0),
    ("Sony", "FE 70-300mm F4.5-5.6 G OSS", 70, 300, 4.5, 5.6, 1.0),
    ("Sony", "FE 100-400mm F4.5-5.6 GM OSS", 100, 400, 4.5, 5.6, 1.0),
    ("Sony", "FE 200-600mm F5.6-6.3 G OSS", 200, 600, 5.6, 6.3, 1.0),
    # --------------------------------------------------------- Sony E APS-C
    ("Sony", "E 10-18mm F4 OSS", 10, 18, 4.0, 4.0, 1.5),
    ("Sony", "E 11mm F1.8", 11, None, 1.8, None, 1.5),
    ("Sony", "E 15mm F1.4 G", 15, None, 1.4, None, 1.5),
    ("Sony", "E 16mm F2.8", 16, None, 2.8, None, 1.5),
    ("Sony", "E 16-55mm F2.8 G", 16, 55, 2.8, 2.8, 1.5),
    ("Sony", "E PZ 18-105mm F4 G OSS", 18, 105, 4.0, 4.0, 1.5),
    ("Sony", "E 18-135mm F3.5-5.6 OSS", 18, 135, 3.5, 5.6, 1.5),
    ("Sony", "E 18-200mm F3.5-6.3 OSS", 18, 200, 3.5, 6.3, 1.5),
    ("Sony", "E 55-210mm F4.5-6.3 OSS", 55, 210, 4.5, 6.3, 1.5),
    ("Sony", "Sonnar T* E 24mm F1.8 ZA", 24, None, 1.8, None, 1.5),
    ("Sony", "E 30mm F3.5 Macro", 30, None, 3.5, None, 1.5),
    ("Sony", "E 35mm F1.8 OSS", 35, None, 1.8, None, 1.5),
    ("Sony", "E 50mm F1.8 OSS", 50, None, 1.8, None, 1.5),
    ("Sony", "E 70-350mm F4.5-6.3 G OSS", 70, 350, 4.5, 6.3, 1.5),
    # ---------------------------------------------------------- Fujifilm XF
    ("Fujifilm", "XF8-16mmF2.8 R LM WR", 8, 16, 2.8, 2.8, 1.5),
    ("Fujifilm", "XF14mmF2.8 R", 14, None, 2.8, None, 1.5),
    ("Fujifilm", "XF16mmF1.4 R WR", 16, None, 1.4, None, 1.5),
    ("Fujifilm", "XF16mmF2.8 R WR", 16, None, 2.8, None, 1.5),
    ("Fujifilm", "XF18mmF1.4 R LM WR", 18, None, 1.4, None, 1.5),
    ("Fujifilm", "XF18mmF2 R", 18, None, 2.0, None, 1.5),
    ("Fujifilm", "XF18-135mmF3.5-5.6 R LM OIS WR", 18, 135, 3.5, 5.6, 1.5),
    ("Fujifilm", "XF23mmF2 R WR", 23, None, 2.0, None, 1.5),
    ("Fujifilm", "XF27mmF2.8 R WR", 27, None, 2.8, None, 1.5),
    ("Fujifilm", "XF33mmF1.4 R LM WR", 33, None, 1.4, None, 1.5),
    ("Fujifilm", "XF35mmF2 R WR", 35, None, 2.0, None, 1.5),
    ("Fujifilm", "XF50mmF1.0 R WR", 50, None, 1.0, None, 1.5),
    ("Fujifilm", "XF50mmF2 R WR", 50, None, 2.0, None, 1.5),
    ("Fujifilm", "XF50-140mmF2.8 R LM OIS WR", 50, 140, 2.8, 2.8, 1.5),
    ("Fujifilm", "XF55-200mmF3.5-4.8 R LM OIS", 55, 200, 3.5, 4.8, 1.5),
    ("Fujifilm", "XF60mmF2.4 R Macro", 60, None, 2.4, None, 1.5),
    ("Fujifilm", "XF70-300mmF4-5.6 R LM OIS WR", 70, 300, 4.0, 5.6, 1.5),
    ("Fujifilm", "XF80mmF2.8 R LM OIS WR Macro", 80, None, 2.8, None, 1.5),
    ("Fujifilm", "XF90mmF2 R LM WR", 90, None, 2.0, None, 1.5),
    ("Fujifilm", "XF100-400mmF4.5-5.6 R LM OIS WR", 100, 400, 4.5, 5.6, 1.5),
    ("Fujifilm", "XC15-45mmF3.5-5.6 OIS PZ", 15, 45, 3.5, 5.6, 1.5),
    ("Fujifilm", "XC50-230mmF4.5-6.7 OIS II", 50, 230, 4.5, 6.7, 1.5),
    # ---------------------------------------------------------- Fujifilm GF
    ("Fujifilm", "GF23mmF4 R LM WR", 23, None, 4.0, None, 0.79),
    ("Fujifilm", "GF32-64mmF4 R LM WR", 32, 64, 4.0, 4.0, 0.79),
    ("Fujifilm", "GF45mmF2.8 R WR", 45, None, 2.8, None, 0.79),
    ("Fujifilm", "GF63mmF2.8 R WR", 63, None, 2.8, None, 0.79),
    ("Fujifilm", "GF110mmF2 R LM WR", 110, None, 2.0, None, 0.79),
    ("Fujifilm", "GF120mmF4 R LM OIS WR Macro", 120, None, 4.0, None, 0.79),
    ("Fujifilm", "GF250mmF4 R LM OIS WR", 250, None, 4.0, None, 0.79),
    # ------------------------------------------------------- Olympus / OM m43
    ("Olympus", "M.ZUIKO DIGITAL ED 7-14mm F2.8 PRO", 7, 14, 2.8, 2.8, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL ED 9-18mm F4.0-5.6", 9, 18, 4.0, 5.6, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL 12mm F2.0", 12, None, 2.0, None, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL ED 12-45mm F4.0 PRO", 12, 45, 4.0, 4.0, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL ED 12-100mm F4.0 IS PRO", 12, 100, 4.0, 4.0, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL ED 12-200mm F3.5-6.3", 12, 200, 3.5, 6.3, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL ED 14-150mm F4.0-5.6 II", 14, 150, 4.0, 5.6, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL ED 17mm F1.2 PRO", 17, None, 1.2, None, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL 17mm F1.8", 17, None, 1.8, None, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL ED 25mm F1.2 PRO", 25, None, 1.2, None, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL 25mm F1.8", 25, None, 1.8, None, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL ED 40-150mm F2.8 PRO", 40, 150, 2.8, 2.8, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL ED 40-150mm F4.0-5.6 R", 40, 150, 4.0, 5.6, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL ED 45mm F1.2 PRO", 45, None, 1.2, None, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL ED 60mm F2.8 Macro", 60, None, 2.8, None, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL ED 75mm F1.8", 75, None, 1.8, None, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL ED 75-300mm F4.8-6.7 II", 75, 300, 4.8, 6.7, 2.0),
    ("Olympus", "M.ZUIKO DIGITAL ED 100-400mm F5.0-6.3 IS", 100, 400, 5.0, 6.3, 2.0),
    # -------------------------------------------------------- Panasonic m43
    ("Panasonic", "LUMIX G VARIO 7-14mm F4.0 ASPH.", 7, 14, 4.0, 4.0, 2.0),
    ("Panasonic", "LEICA DG VARIO-ELMARIT 8-18mm F2.8-4.0", 8, 18, 2.8, 4.0, 2.0),
    ("Panasonic", "LUMIX G 9mm F1.7 ASPH.", 9, None, 1.7, None, 2.0),
    ("Panasonic", "LEICA DG VARIO-SUMMILUX 10-25mm F1.7", 10, 25, 1.7, 1.7, 2.0),
    ("Panasonic", "LUMIX G X VARIO 12-35mm F2.8 II ASPH.", 12, 35, 2.8, 2.8, 2.0),
    ("Panasonic", "LEICA DG VARIO-ELMARIT 12-60mm F2.8-4.0", 12, 60, 2.8, 4.0, 2.0),
    ("Panasonic", "LUMIX G VARIO 14-140mm F3.5-5.6 II", 14, 140, 3.5, 5.6, 2.0),
    ("Panasonic", "LEICA DG SUMMILUX 15mm F1.7 ASPH.", 15, None, 1.7, None, 2.0),
    ("Panasonic", "LUMIX G 20mm F1.7 II ASPH.", 20, None, 1.7, None, 2.0),
    ("Panasonic", "LEICA DG SUMMILUX 25mm F1.4 II ASPH.", 25, None, 1.4, None, 2.0),
    ("Panasonic", "LUMIX G 25mm F1.7 ASPH.", 25, None, 1.7, None, 2.0),
    ("Panasonic", "LUMIX G X VARIO 35-100mm F2.8 II", 35, 100, 2.8, 2.8, 2.0),
    ("Panasonic", "LEICA DG NOCTICRON 42.5mm F1.2 ASPH.", 42.5, None, 1.2, None, 2.0),
    ("Panasonic", "LUMIX G 42.5mm F1.7 ASPH.", 42.5, None, 1.7, None, 2.0),
    ("Panasonic", "LUMIX G VARIO 45-150mm F4.0-5.6 ASPH.", 45, 150, 4.0, 5.6, 2.0),
    ("Panasonic", "LUMIX G X VARIO PZ 45-175mm F4.0-5.6", 45, 175, 4.0, 5.6, 2.0),
    ("Panasonic", "LEICA DG VARIO-ELMAR 100-400mm F4.0-6.3", 100, 400, 4.0, 6.3, 2.0),
    ("Panasonic", "LEICA DG VARIO-ELMARIT 50-200mm F2.8-4.0", 50, 200, 2.8, 4.0, 2.0),
    ("Panasonic", "LUMIX G VARIO 100-300mm F4.0-5.6 II", 100, 300, 4.0, 5.6, 2.0),
    # --------------------------------------------------- Panasonic L-mount
    ("Panasonic", "LUMIX S 16-35mm F4", 16, 35, 4.0, 4.0, 1.0),
    ("Panasonic", "LUMIX S 20-60mm F3.5-5.6", 20, 60, 3.5, 5.6, 1.0),
    ("Panasonic", "LUMIX S PRO 24-70mm F2.8", 24, 70, 2.8, 2.8, 1.0),
    ("Panasonic", "LUMIX S 24-105mm F4 MACRO O.I.S.", 24, 105, 4.0, 4.0, 1.0),
    ("Panasonic", "LUMIX S PRO 70-200mm F2.8 O.I.S.", 70, 200, 2.8, 2.8, 1.0),
    ("Panasonic", "LUMIX S 70-300mm F4.5-5.6 MACRO O.I.S.", 70, 300, 4.5, 5.6, 1.0),
    ("Panasonic", "LUMIX S PRO 50mm F1.4", 50, None, 1.4, None, 1.0),
    ("Panasonic", "LUMIX S 50mm F1.8", 50, None, 1.8, None, 1.0),
    ("Panasonic", "LUMIX S 85mm F1.8", 85, None, 1.8, None, 1.0),
    ("Panasonic", "LUMIX S 24mm F1.8", 24, None, 1.8, None, 1.0),
    ("Panasonic", "LUMIX S 35mm F1.8", 35, None, 1.8, None, 1.0),
    ("Panasonic", "LUMIX S 18mm F1.8", 18, None, 1.8, None, 1.0),
    # ------------------------------------------------------------- Pentax K
    ("Pentax", "HD PENTAX-DA 15mm F4 ED AL Limited", 15, None, 4.0, None, 1.5),
    ("Pentax", "HD PENTAX-DA 21mm F3.2 AL Limited", 21, None, 3.2, None, 1.5),
    ("Pentax", "HD PENTAX-FA 31mm F1.8 Limited", 31, None, 1.8, None, 1.0),
    ("Pentax", "HD PENTAX-DA 35mm F2.4 AL", 35, None, 2.4, None, 1.5),
    ("Pentax", "HD PENTAX-DA 40mm F2.8 Limited", 40, None, 2.8, None, 1.5),
    ("Pentax", "HD PENTAX-FA 43mm F1.9 Limited", 43, None, 1.9, None, 1.0),
    ("Pentax", "HD PENTAX-FA 50mm F1.4", 50, None, 1.4, None, 1.0),
    ("Pentax", "smc PENTAX-DA 50mm F1.8", 50, None, 1.8, None, 1.5),
    ("Pentax", "HD PENTAX-DA 70mm F2.4 Limited", 70, None, 2.4, None, 1.5),
    ("Pentax", "HD PENTAX-FA 77mm F1.8 Limited", 77, None, 1.8, None, 1.0),
    ("Pentax", "HD PENTAX-D FA 100mm F2.8 Macro WR", 100, None, 2.8, None, 1.0),
    ("Pentax", "HD PENTAX-DA 16-85mm F3.5-5.6 ED DC WR", 16, 85, 3.5, 5.6, 1.5),
    ("Pentax", "smc PENTAX-DA 17-70mm F4 AL IF SDM", 17, 70, 4.0, 4.0, 1.5),
    ("Pentax", "smc PENTAX-DA 18-55mm F3.5-5.6 AL WR", 18, 55, 3.5, 5.6, 1.5),
    ("Pentax", "HD PENTAX-DA 18-135mm F3.5-5.6 ED AL IF DC WR", 18, 135, 3.5, 5.6, 1.5),
    ("Pentax", "HD PENTAX-DA 20-40mm F2.8-4 Limited DC WR", 20, 40, 2.8, 4.0, 1.5),
    ("Pentax", "HD PENTAX-DA 55-300mm F4.5-6.3 ED PLM WR RE", 55, 300, 4.5, 6.3, 1.5),
    ("Pentax", "HD PENTAX-D FA 24-70mm F2.8 ED SDM WR", 24, 70, 2.8, 2.8, 1.0),
    ("Pentax", "HD PENTAX-D FA 15-30mm F2.8 ED SDM WR", 15, 30, 2.8, 2.8, 1.0),
    ("Pentax", "HD PENTAX-D FA 70-210mm F4 ED SDM WR", 70, 210, 4.0, 4.0, 1.0),
    ("Pentax", "HD PENTAX-D FA* 50mm F1.4 SDM AW", 50, None, 1.4, None, 1.0),
    # ---------------------------------------------------------------- Sigma
    ("Sigma", "14mm F1.8 DG HSM", 14, None, 1.8, None, 1.0),
    ("Sigma", "14-24mm F2.8 DG HSM", 14, 24, 2.8, 2.8, 1.0),
    ("Sigma", "14-24mm F2.8 DG DN", 14, 24, 2.8, 2.8, 1.0),
    ("Sigma", "16mm F1.4 DC DN", 16, None, 1.4, None, 1.5),
    ("Sigma", "16-28mm F2.8 DG DN", 16, 28, 2.8, 2.8, 1.0),
    ("Sigma", "17-70mm F2.8-4 DC Macro OS HSM", 17, 70, 2.8, 4.0, 1.5),
    ("Sigma", "18-300mm F3.5-6.3 DC Macro OS HSM", 18, 300, 3.5, 6.3, 1.5),
    ("Sigma", "20mm F1.4 DG HSM", 20, None, 1.4, None, 1.0),
    ("Sigma", "20mm F2 DG DN", 20, None, 2.0, None, 1.0),
    ("Sigma", "23mm F1.4 DC DN", 23, None, 1.4, None, 1.5),
    ("Sigma", "24mm F1.4 DG HSM", 24, None, 1.4, None, 1.0),
    ("Sigma", "24mm F2 DG DN", 24, None, 2.0, None, 1.0),
    ("Sigma", "24-35mm F2 DG HSM", 24, 35, 2.0, 2.0, 1.0),
    ("Sigma", "24-70mm F2.8 DG OS HSM", 24, 70, 2.8, 2.8, 1.0),
    ("Sigma", "24-70mm F2.8 DG DN", 24, 70, 2.8, 2.8, 1.0),
    ("Sigma", "28mm F1.4 DG HSM", 28, None, 1.4, None, 1.0),
    ("Sigma", "28-70mm F2.8 DG DN", 28, 70, 2.8, 2.8, 1.0),
    ("Sigma", "30mm F1.4 DC DN", 30, None, 1.4, None, 1.5),
    ("Sigma", "35mm F1.2 DG DN", 35, None, 1.2, None, 1.0),
    ("Sigma", "40mm F1.4 DG HSM", 40, None, 1.4, None, 1.0),
    ("Sigma", "45mm F2.8 DG DN", 45, None, 2.8, None, 1.0),
    ("Sigma", "50-100mm F1.8 DC HSM", 50, 100, 1.8, 1.8, 1.5),
    ("Sigma", "56mm F1.4 DC DN", 56, None, 1.4, None, 1.5),
    ("Sigma", "65mm F2 DG DN", 65, None, 2.0, None, 1.0),
    ("Sigma", "85mm F1.4 DG HSM", 85, None, 1.4, None, 1.0),
    ("Sigma", "85mm F1.4 DG DN", 85, None, 1.4, None, 1.0),
    ("Sigma", "90mm F2.8 DG DN", 90, None, 2.8, None, 1.0),
    ("Sigma", "105mm F1.4 DG HSM", 105, None, 1.4, None, 1.0),
    ("Sigma", "105mm F2.8 DG DN Macro", 105, None, 2.8, None, 1.0),
    ("Sigma", "135mm F1.8 DG HSM", 135, None, 1.8, None, 1.0),
    ("Sigma", "100-400mm F5-6.3 DG DN OS", 100, 400, 5.0, 6.3, 1.0),
    ("Sigma", "150-600mm F5-6.3 DG DN OS", 150, 600, 5.0, 6.3, 1.0),
    ("Sigma", "60-600mm F4.5-6.3 DG OS HSM", 60, 600, 4.5, 6.3, 1.0),
    # --------------------------------------------------------------- Tamron
    ("Tamron", "11-20mm F/2.8 Di III-A RXD", 11, 20, 2.8, 2.8, 1.5),
    ("Tamron", "15-30mm F/2.8 Di VC USD G2", 15, 30, 2.8, 2.8, 1.0),
    ("Tamron", "17-28mm F/2.8 Di III RXD", 17, 28, 2.8, 2.8, 1.0),
    ("Tamron", "SP AF 17-50mm F/2.8 XR Di II", 17, 50, 2.8, 2.8, 1.5),
    ("Tamron", "17-70mm F/2.8 Di III-A VC RXD", 17, 70, 2.8, 2.8, 1.5),
    ("Tamron", "18-200mm F/3.5-6.3 Di II VC", 18, 200, 3.5, 6.3, 1.5),
    ("Tamron", "18-300mm F/3.5-6.3 Di III-A VC VXD", 18, 300, 3.5, 6.3, 1.5),
    ("Tamron", "18-400mm F/3.5-6.3 Di II VC HLD", 18, 400, 3.5, 6.3, 1.5),
    ("Tamron", "20mm F/2.8 Di III OSD M1:2", 20, None, 2.8, None, 1.0),
    ("Tamron", "24mm F/2.8 Di III OSD M1:2", 24, None, 2.8, None, 1.0),
    ("Tamron", "SP 24-70mm F/2.8 Di VC USD G2", 24, 70, 2.8, 2.8, 1.0),
    ("Tamron", "28-75mm F/2.8 Di III VXD G2", 28, 75, 2.8, 2.8, 1.0),
    ("Tamron", "28-200mm F/2.8-5.6 Di III RXD", 28, 200, 2.8, 5.6, 1.0),
    ("Tamron", "28-300mm F/3.5-6.3 Di VC PZD", 28, 300, 3.5, 6.3, 1.0),
    ("Tamron", "SP 35mm F/1.4 Di USD", 35, None, 1.4, None, 1.0),
    ("Tamron", "SP 35mm F/1.8 Di VC USD", 35, None, 1.8, None, 1.0),
    ("Tamron", "35-150mm F/2-2.8 Di III VXD", 35, 150, 2.0, 2.8, 1.0),
    ("Tamron", "SP 45mm F/1.8 Di VC USD", 45, None, 1.8, None, 1.0),
    ("Tamron", "50-400mm F/4.5-6.3 Di III VC VXD", 50, 400, 4.5, 6.3, 1.0),
    ("Tamron", "70-180mm F/2.8 Di III VXD", 70, 180, 2.8, 2.8, 1.0),
    ("Tamron", "SP 70-200mm F/2.8 Di VC USD G2", 70, 200, 2.8, 2.8, 1.0),
    ("Tamron", "70-300mm F/4.5-6.3 Di III RXD", 70, 300, 4.5, 6.3, 1.0),
    ("Tamron", "SP 85mm F/1.8 Di VC USD", 85, None, 1.8, None, 1.0),
    ("Tamron", "SP 90mm F/2.8 Di Macro 1:1 VC USD", 90, None, 2.8, None, 1.0),
    ("Tamron", "100-400mm F/4.5-6.3 Di VC USD", 100, 400, 4.5, 6.3, 1.0),
    ("Tamron", "150-500mm F/5-6.7 Di III VC VXD", 150, 500, 5.0, 6.7, 1.0),
    ("Tamron", "SP 150-600mm F/5-6.3 Di VC USD G2", 150, 600, 5.0, 6.3, 1.0),
    # --------------------------------------------------------------- Tokina
    ("Tokina", "AT-X 11-16mm F2.8 PRO DX II", 11, 16, 2.8, 2.8, 1.5),
    ("Tokina", "atx-i 11-20mm F2.8 CF", 11, 20, 2.8, 2.8, 1.5),
    ("Tokina", "AT-X 12-24mm F4 PRO DX", 12, 24, 4.0, 4.0, 1.5),
    ("Tokina", "AT-X 14-20mm F2 PRO DX", 14, 20, 2.0, 2.0, 1.5),
    ("Tokina", "opera 16-28mm F2.8 FF", 16, 28, 2.8, 2.8, 1.0),
    ("Tokina", "AT-X 17-35mm F4 PRO FX", 17, 35, 4.0, 4.0, 1.0),
    ("Tokina", "opera 24-70mm F2.8 FF", 24, 70, 2.8, 2.8, 1.0),
    ("Tokina", "atx-i 100mm F2.8 FF Macro", 100, None, 2.8, None, 1.0),
    # ---------------------------------------------------------------- Zeiss
    ("Zeiss", "Batis 2.8/18", 18, None, 2.8, None, 1.0),
    ("Zeiss", "Batis 2/25", 25, None, 2.0, None, 1.0),
    ("Zeiss", "Batis 2/40 CF", 40, None, 2.0, None, 1.0),
    ("Zeiss", "Batis 1.8/85", 85, None, 1.8, None, 1.0),
    ("Zeiss", "Batis 2.8/135", 135, None, 2.8, None, 1.0),
    ("Zeiss", "Loxia 2.8/21", 21, None, 2.8, None, 1.0),
    ("Zeiss", "Loxia 2.4/25", 25, None, 2.4, None, 1.0),
    ("Zeiss", "Loxia 2/35", 35, None, 2.0, None, 1.0),
    ("Zeiss", "Loxia 2/50", 50, None, 2.0, None, 1.0),
    ("Zeiss", "Loxia 2.4/85", 85, None, 2.4, None, 1.0),
    ("Zeiss", "Otus 1.4/28", 28, None, 1.4, None, 1.0),
    ("Zeiss", "Otus 1.4/55", 55, None, 1.4, None, 1.0),
    ("Zeiss", "Otus 1.4/85", 85, None, 1.4, None, 1.0),
    ("Zeiss", "Milvus 2.8/21", 21, None, 2.8, None, 1.0),
    ("Zeiss", "Milvus 1.4/25", 25, None, 1.4, None, 1.0),
    ("Zeiss", "Milvus 1.4/35", 35, None, 1.4, None, 1.0),
    ("Zeiss", "Milvus 2/35", 35, None, 2.0, None, 1.0),
    ("Zeiss", "Milvus 1.4/50", 50, None, 1.4, None, 1.0),
    ("Zeiss", "Milvus 1.4/85", 85, None, 1.4, None, 1.0),
    ("Zeiss", "Milvus 2/100M", 100, None, 2.0, None, 1.0),
    ("Zeiss", "Planar T* 1.4/50 ZF.2", 50, None, 1.4, None, 1.0),
    ("Zeiss", "Touit 2.8/12", 12, None, 2.8, None, 1.5),
    ("Zeiss", "Touit 1.8/32", 32, None, 1.8, None, 1.5),
    ("Zeiss", "Touit 2.8/50M", 50, None, 2.8, None, 1.5),
    # ----------------------------------------------------- Samyang / Rokinon
    ("Samyang", "12mm F2.0 NCS CS", 12, None, 2.0, None, 1.5),
    ("Samyang", "14mm F2.8 ED AS IF UMC", 14, None, 2.8, None, 1.0),
    ("Samyang", "SP 14mm F2.4", 14, None, 2.4, None, 1.0),
    ("Samyang", "AF 18mm F2.8 FE", 18, None, 2.8, None, 1.0),
    ("Samyang", "24mm F1.4 ED AS IF UMC", 24, None, 1.4, None, 1.0),
    ("Samyang", "AF 24mm F2.8 FE", 24, None, 2.8, None, 1.0),
    ("Samyang", "AF 35mm F1.4 FE", 35, None, 1.4, None, 1.0),
    ("Samyang", "AF 35mm F1.8 FE", 35, None, 1.8, None, 1.0),
    ("Samyang", "AF 35mm F2.8 FE", 35, None, 2.8, None, 1.0),
    ("Samyang", "AF 45mm F1.8 FE", 45, None, 1.8, None, 1.0),
    ("Samyang", "AF 50mm F1.4 FE", 50, None, 1.4, None, 1.0),
    ("Samyang", "AF 75mm F1.8 FE", 75, None, 1.8, None, 1.0),
    ("Samyang", "AF 85mm F1.4 FE", 85, None, 1.4, None, 1.0),
    ("Samyang", "85mm F1.4 AS IF UMC", 85, None, 1.4, None, 1.0),
    ("Samyang", "135mm F2.0 ED UMC", 135, None, 2.0, None, 1.0),
    # -------------------------------------------------------------- Leica M
    ("Leica", "SUPER-ELMAR-M 21mm f/3.4 ASPH.", 21, None, 3.4, None, 1.0),
    ("Leica", "ELMAR-M 24mm f/3.8 ASPH.", 24, None, 3.8, None, 1.0),
    ("Leica", "SUMMILUX-M 28mm f/1.4 ASPH.", 28, None, 1.4, None, 1.0),
    ("Leica", "SUMMICRON-M 28mm f/2 ASPH.", 28, None, 2.0, None, 1.0),
    ("Leica", "ELMARIT-M 28mm f/2.8 ASPH.", 28, None, 2.8, None, 1.0),
    ("Leica", "SUMMILUX-M 35mm f/1.4 ASPH.", 35, None, 1.4, None, 1.0),
    ("Leica", "SUMMICRON-M 35mm f/2 ASPH.", 35, None, 2.0, None, 1.0),
    ("Leica", "NOCTILUX-M 50mm f/0.95 ASPH.", 50, None, 0.95, None, 1.0),
    ("Leica", "SUMMILUX-M 50mm f/1.4 ASPH.", 50, None, 1.4, None, 1.0),
    ("Leica", "SUMMICRON-M 50mm f/2", 50, None, 2.0, None, 1.0),
    ("Leica", "APO-SUMMICRON-M 50mm f/2 ASPH.", 50, None, 2.0, None, 1.0),
    ("Leica", "NOCTILUX-M 75mm f/1.25 ASPH.", 75, None, 1.25, None, 1.0),
    ("Leica", "APO-SUMMICRON-M 75mm f/2 ASPH.", 75, None, 2.0, None, 1.0),
    ("Leica", "APO-SUMMICRON-M 90mm f/2 ASPH.", 90, None, 2.0, None, 1.0),
    ("Leica", "APO-TELYT-M 135mm f/3.4", 135, None, 3.4, None, 1.0),
    # ----------------------------------------------------------- Leica Q/SL
    ("Leica", "SUMMILUX 28mm f/1.7 ASPH.", 28, None, 1.7, None, 1.0),
    ("Leica", "VARIO-ELMARIT-SL 24-90mm f/2.8-4 ASPH.", 24, 90, 2.8, 4.0, 1.0),
    ("Leica", "SUMMILUX-SL 50mm f/1.4 ASPH.", 50, None, 1.4, None, 1.0),
    ("Leica", "APO-SUMMICRON-SL 35mm f/2 ASPH.", 35, None, 2.0, None, 1.0),
    ("Leica", "APO-SUMMICRON-SL 50mm f/2 ASPH.", 50, None, 2.0, None, 1.0),
    ("Leica", "APO-SUMMICRON-SL 75mm f/2 ASPH.", 75, None, 2.0, None, 1.0),
    ("Leica", "APO-SUMMICRON-SL 90mm f/2 ASPH.", 90, None, 2.0, None, 1.0),
    ("Leica", "SUPER-VARIO-ELMAR-SL 16-35mm f/3.5-4.5", 16, 35, 3.5, 4.5, 1.0),
    ("Leica", "APO-VARIO-ELMARIT-SL 90-280mm f/2.8-4", 90, 280, 2.8, 4.0, 1.0),
    # ---------------------------------------------------------- Voigtlander
    ("Voigtlander", "SUPER WIDE-HELIAR 15mm F4.5 III", 15, None, 4.5, None, 1.0),
    ("Voigtlander", "NOKTON 21mm F1.4 Aspherical", 21, None, 1.4, None, 1.0),
    ("Voigtlander", "COLOR-SKOPAR 21mm F3.5 Aspherical", 21, None, 3.5, None, 1.0),
    ("Voigtlander", "NOKTON classic 35mm F1.4 II", 35, None, 1.4, None, 1.0),
    ("Voigtlander", "APO-LANTHAR 35mm F2 Aspherical", 35, None, 2.0, None, 1.0),
    ("Voigtlander", "NOKTON 40mm F1.2 Aspherical", 40, None, 1.2, None, 1.0),
    ("Voigtlander", "NOKTON 50mm F1.2 Aspherical", 50, None, 1.2, None, 1.0),
    ("Voigtlander", "APO-LANTHAR 50mm F2 Aspherical", 50, None, 2.0, None, 1.0),
    ("Voigtlander", "MACRO APO-LANTHAR 65mm F2", 65, None, 2.0, None, 1.0),
    ("Voigtlander", "NOKTON 75mm F1.5 Aspherical", 75, None, 1.5, None, 1.0),
    ("Voigtlander", "MACRO APO-LANTHAR 110mm F2.5", 110, None, 2.5, None, 1.0),
    # ---------------------------------------------------------------- Laowa
    ("Laowa", "9mm F2.8 Zero-D", 9, None, 2.8, None, 1.5),
    ("Laowa", "10-18mm F4.5-5.6 FE Zoom", 10, 18, 4.5, 5.6, 1.0),
    ("Laowa", "12mm F2.8 Zero-D", 12, None, 2.8, None, 1.0),
    ("Laowa", "15mm F2 Zero-D FE", 15, None, 2.0, None, 1.0),
    ("Laowa", "25mm F2.8 2.5-5X Ultra Macro", 25, None, 2.8, None, 1.0),
    ("Laowa", "60mm F2.8 2X Ultra-Macro", 60, None, 2.8, None, 1.0),
    ("Laowa", "100mm F2.8 2X Ultra Macro APO", 100, None, 2.8, None, 1.0),
    ("Laowa", "105mm F2 Smooth Trans Focus", 105, None, 2.0, None, 1.0),
    # --------------------------------------------- budget mirrorless primes
    ("7Artisans", "7Artisans 25mm F1.8", 25, None, 1.8, None, 1.5),
    ("7Artisans", "7Artisans 35mm F1.2", 35, None, 1.2, None, 1.5),
    ("7Artisans", "7Artisans 50mm F1.1", 50, None, 1.1, None, 1.0),
    ("7Artisans", "7Artisans 55mm F1.4", 55, None, 1.4, None, 1.5),
    ("TTArtisan", "TTArtisan 17mm F1.4 ASPH", 17, None, 1.4, None, 1.5),
    ("TTArtisan", "TTArtisan 35mm F1.4", 35, None, 1.4, None, 1.5),
    ("TTArtisan", "TTArtisan 50mm F0.95 ASPH", 50, None, 0.95, None, 1.0),
    ("Meike", "Meike 35mm F1.7", 35, None, 1.7, None, 1.5),
    ("Meike", "Meike 50mm F1.7", 50, None, 1.7, None, 1.0),
    # ------------------------------------------------------- Sony A / Minolta
    ("Sony", "Vario-Sonnar T* DT 16-80mm F3.5-4.5 ZA", 16, 80, 3.5, 4.5, 1.5),
    ("Sony", "Vario-Sonnar T* 24-70mm F2.8 ZA SSM", 24, 70, 2.8, 2.8, 1.0),
    ("Sony", "Sony 50mm F1.4 SAL50F14", 50, None, 1.4, None, 1.0),
    ("Sony", "Planar T* 85mm F1.4 ZA", 85, None, 1.4, None, 1.0),
    ("Sony", "70-400mm F4-5.6 G SSM II", 70, 400, 4.0, 5.6, 1.0),
    # ----------------------------------------------- additional popular glass
    ("Canon", "EF 17-40mm f/4L", 17, 40, 4.0, 4.0, 1.0),
    ("Canon", "RF 16-28mm F2.8 IS STM", 16, 28, 2.8, 2.8, 1.0),
    ("Canon", "RF 24-50mm F4.5-6.3 IS STM", 24, 50, 4.5, 6.3, 1.0),
    ("Canon", "RF 35mm F1.4 L VCM", 35, None, 1.4, None, 1.0),
    ("Nikon", "NIKKOR Z 24-70mm f/4 S kit", 24, 70, 4.0, 4.0, 1.0),
    ("Nikon", "NIKKOR Z 180-600mm f/5.6-6.3 VR", 180, 600, 5.6, 6.3, 1.0),
    ("Nikon", "NIKKOR Z 35mm f/1.4", 35, None, 1.4, None, 1.0),
    ("Nikon", "NIKKOR Z 50mm f/1.4", 50, None, 1.4, None, 1.0),
    ("Sony", "FE 24-50mm F2.8 G", 24, 50, 2.8, 2.8, 1.0),
    ("Sony", "FE 16-25mm F2.8 G", 16, 25, 2.8, 2.8, 1.0),
    ("Sony", "FE 85mm F1.4 GM II", 85, None, 1.4, None, 1.0),
    ("Sony", "FE 28-70mm F2 GM", 28, 70, 2.0, 2.0, 1.0),
    ("Fujifilm", "XF16-50mmF2.8-4.8 R LM WR", 16, 50, 2.8, 4.8, 1.5),
    ("Fujifilm", "XF23mmF1.4 R LM WR", 23, None, 1.4, None, 1.5),
    ("Fujifilm", "XF30mmF2.8 R LM WR Macro", 30, None, 2.8, None, 1.5),
    ("Fujifilm", "XF150-600mmF5.6-8 R LM OIS WR", 150, 600, 5.6, 8.0, 1.5),
    ("Sigma", "24-70mm F2.8 DG DN II", 24, 70, 2.8, 2.8, 1.0),
    ("Sigma", "70-200mm F2.8 DG DN OS", 70, 200, 2.8, 2.8, 1.0),
    ("Sigma", "500mm F5.6 DG DN OS", 500, None, 5.6, None, 1.0),
    ("Tamron", "28-300mm F/4-7.1 Di III VC VXD", 28, 300, 4.0, 7.1, 1.0),
    ("Tamron", "50-300mm F/4.5-6.3 Di III VC VXD", 50, 300, 4.5, 6.3, 1.0),
    ("OM SYSTEM", "M.ZUIKO DIGITAL ED 20mm F1.4 PRO", 20, None, 1.4, None, 2.0),
    ("OM SYSTEM", "M.ZUIKO DIGITAL ED 40-150mm F4.0 PRO", 40, 150, 4.0, 4.0, 2.0),
    ("OM SYSTEM", "M.ZUIKO DIGITAL ED 90mm F3.5 Macro IS PRO", 90, None, 3.5, None, 2.0),
    ("Panasonic", "LUMIX S 28-200mm F4-7.1 MACRO O.I.S.", 28, 200, 4.0, 7.1, 1.0),
    ("Panasonic", "LUMIX S 100mm F2.8 MACRO", 100, None, 2.8, None, 1.0),
    ("Viltrox", "AF 13mm F1.4", 13, None, 1.4, None, 1.5),
    ("Viltrox", "AF 27mm F1.2 Pro", 27, None, 1.2, None, 1.5),
    ("Viltrox", "AF 35mm F1.8 FE", 35, None, 1.8, None, 1.0),
    ("Viltrox", "AF 75mm F1.2 Pro", 75, None, 1.2, None, 1.5),
    ("Viltrox", "AF 85mm F1.8 II FE", 85, None, 1.8, None, 1.0),
    ("Hasselblad", "XCD 2,8/65", 65, None, 2.8, None, 0.79),
    ("Hasselblad", "XCD 3,5/45", 45, None, 3.5, None, 0.79),
    ("Hasselblad", "XCD 4/21", 21, None, 4.0, None, 0.79),
    ("Hasselblad", "XCD 2,5/38V", 38, None, 2.5, None, 0.79),
    ("Hasselblad", "XCD 2,5/90V", 90, None, 2.5, None, 0.79),
]


@lru_cache(maxsize=1)
def catalog_profiles():
    """Materialize the catalog rows into LensProfile objects via the same
    generators the curated list uses (lens_db._prime/_zoom)."""
    from raw2film_tpu_torch.io.lens_db import _prime, _zoom

    out = []
    for make, model, wide, tele, f_wide, f_tele, crop in _ROWS:
        eq_w = wide * crop
        if tele is None:
            fast = f_wide <= 1.5
            vig = 1.2 if fast else (1.1 if f_wide <= 2.0 else 1.0)
            out.append(
                _prime(
                    make, model, wide, f_wide,
                    _k1_prime(eq_w, model), crop=crop, vig_strength=vig,
                    confidence="heuristic",
                )
            )
        else:
            eq_t = tele * crop
            ratio = tele / wide
            fast = f_wide <= 2.9
            vig = 0.8 if eq_w >= 50 else (1.2 if eq_w <= 15 else 1.0)
            out.append(
                _zoom(
                    make, model, wide, tele, f_wide, f_tele,
                    _k1_zoom_wide(eq_w, ratio, fast),
                    _k1_zoom_tele(eq_t, ratio),
                    crop=crop, vig_strength=vig,
                    confidence="heuristic",
                )
            )
    return out
