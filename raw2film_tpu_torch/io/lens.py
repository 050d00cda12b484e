"""Lens correction: geometric distortion and vignetting, without JAX.

The counterpart of ``raw2film_tpu/io/lens.py``, which imports ``jax.numpy``
(and so does ``io/lens_db.py`` through it): the profile model, the database
loading, the EXIF matching and ``lens_correction`` are a copy of that
module, with the vignetting gain in numpy float32 instead of on the device.
The distortion remap is the native threaded bilinear remap with scipy's
``map_coordinates`` as its fallback, as in the JAX package. The curated
profiles are the port's copies of ``lens_db`` and ``lens_catalog``, built
with this module's :class:`LensProfile`. Pinned to the JAX
module by tests/test_torch_io.py.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os

import numpy as np

CONFIDENCE_RANK = {"measured": 0, "curated": 1, "heuristic": 2, "synthetic": 3}


@dataclasses.dataclass(frozen=True)
class LensProfile:
    make: str
    model: str
    crop_factor: float = 1.0
    mount: str = ""
    dist_model: str = "ptlens"  # "ptlens" | "poly3" | "none"
    dist_params: tuple = ()  # ((focal_mm, a, b, c) | (focal_mm, k1), ...)
    vig_params: tuple = ()  # ((focal_mm, aperture, k1, k2, k3), ...)
    confidence: str = "measured"

    def distortion_at(self, focal: float):
        if self.dist_model == "none" or not self.dist_params:
            return None
        pts = np.asarray(sorted(self.dist_params), np.float64)
        return tuple(float(np.interp(focal, pts[:, 0], pts[:, i])) for i in range(1, pts.shape[1]))

    def vignetting_at(self, focal: float, aperture: float):
        if not self.vig_params:
            return None
        rows = np.asarray(sorted(self.vig_params), np.float64)
        focals = np.unique(rows[:, 0])
        f = focals[np.argmin(np.abs(focals - focal))]  # nearest focal, then over aperture
        sel = rows[rows[:, 0] == f]
        return tuple(float(np.interp(aperture, sel[:, 1], sel[:, 2 + i])) for i in range(3))


_BUILTIN_PROFILES: list[LensProfile] = [
    LensProfile(
        make="raw2film-tpu",
        model="synthetic 50mm f/2",
        crop_factor=1.0,
        dist_model="ptlens",
        dist_params=((50.0, 0.0, -0.015, 0.005),),
        vig_params=((50.0, 2.0, -0.9, 0.2, -0.05), (50.0, 8.0, -0.3, 0.05, 0.0)),
        confidence="synthetic",
    ),
]


@functools.lru_cache(maxsize=4)
def _load_user_db(path: str, mtime: float) -> list[LensProfile]:
    with open(path) as f:
        out = []
        for row in json.load(f):
            row["dist_params"] = tuple(tuple(x) for x in row.get("dist_params", []))
            row["vig_params"] = tuple(tuple(x) for x in row.get("vig_params", []))
            out.append(LensProfile(**row))
        return out


@functools.lru_cache(maxsize=1)
def _curated_tables() -> tuple[tuple, tuple]:
    from raw2film_tpu_torch.io import lens_catalog, lens_db

    return tuple(lens_db.PROFILES), tuple(lens_catalog.catalog_profiles())


def load_profiles(path: str | None = None) -> list[LensProfile]:
    """The user JSON database (``path``, then ``~/.raw2film_tpu/lenses.json``),
    then the curated profiles, the catalog and the synthetic test profile."""
    profiles: list[LensProfile] = []
    candidates = [path] if path else []
    candidates.append(os.path.expanduser("~/.raw2film_tpu/lenses.json"))
    for p in candidates:
        if p and os.path.exists(p):
            profiles.extend(_load_user_db(p, os.path.getmtime(p)))
    curated, catalog = _curated_tables()
    profiles.extend(curated)
    profiles.extend(catalog)
    profiles.extend(_BUILTIN_PROFILES)
    return profiles


def _loose(a: str, b: str) -> bool:
    a, b = (a or "").lower(), (b or "").lower()
    return bool(a) and bool(b) and (a in b or b in a)


def _compact(s: str) -> str:
    return (s or "").lower().replace(" ", "").replace("/", "")


def _model_match(profile_model: str, exif_model: str) -> bool:
    """The profile's model string must appear in the EXIF LensModel (both
    compacted); never the reverse."""
    a, b = _compact(profile_model), _compact(exif_model)
    return bool(a) and bool(b) and a in b


def find_profile(metadata: dict, profiles: list[LensProfile] | None = None):
    """The best profile for the EXIF: by lens model (highest confidence
    first), or, for a file without a LensModel, by make within the
    profile's characterized focal range. None when nothing matches."""
    profiles = profiles if profiles is not None else load_profiles()
    lens_model = str(metadata.get("EXIF:LensModel", "") or "")
    matches = [p for p in profiles if _model_match(p.model, lens_model)]
    if matches:
        return min(matches, key=lambda p: CONFIDENCE_RANK.get(p.confidence, 9))
    if not lens_model:
        make = str(metadata.get("EXIF:LensMake", "") or metadata.get("EXIF:Make", "") or "")
        try:
            focal = float(metadata.get("EXIF:FocalLength"))
        except (TypeError, ValueError):
            focal = None
        if focal is None:
            return None
        for p in profiles:
            if not _loose(p.make, make):
                continue
            focals = [row[0] for row in (p.dist_params or p.vig_params)]
            if focals and min(focals) - 0.5 <= focal <= max(focals) + 0.5:
                return p
    return None


_warned_missing: set = set()


def _warn_missing_profile(metadata: dict) -> None:
    """Once per (make, lens): lens correction asked for with no profile."""
    key = (str(metadata.get("EXIF:Make", "")), str(metadata.get("EXIF:LensModel", "")))
    if key in _warned_missing or not any(key):
        return
    _warned_missing.add(key)
    import warnings

    warnings.warn(
        f"no lens profile for {key[0]!r} / {key[1]!r}; lens correction "
        "skipped (run raw2film-tpu --import-lensfun <lensfun-db-dir> to "
        "build a profile database)",
        stacklevel=3,
    )


def vignetting_gain(shape_hw: tuple[int, int], ks: tuple[float, float, float]) -> np.ndarray:
    """(H, W) float32 gain 1 / (1 + k1 r^2 + k2 r^4 + k3 r^6), r normalized
    to the half-diagonal, in the JAX form's float32 order."""
    h, w = shape_hw
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    norm = 1.0 / math.hypot(cy, cx)
    yy = (np.arange(h, dtype=np.float32) - np.float32(cy))[:, None] * np.float32(norm)
    xx = (np.arange(w, dtype=np.float32) - np.float32(cx))[None, :] * np.float32(norm)
    r2 = yy * yy + xx * xx
    k1, k2, k3 = (np.float32(k) for k in ks)
    falloff = np.float32(1.0) + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    return np.float32(1.0) / np.clip(falloff, np.float32(0.05), None)


def undistort_coords(shape_hw: tuple[int, int], model: str, params: tuple) -> np.ndarray:
    """(2, H, W) source coordinates of the inverse radial map."""
    h, w = shape_hw
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    norm = 1.0 / math.hypot(cy, cx)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dy = (yy - cy) * norm
    dx = (xx - cx) * norm
    r = np.sqrt(dy * dy + dx * dx)
    if model == "ptlens":
        a, b, c = params
        scale = a * r**3 + b * r**2 + c * r + (1 - a - b - c)
    elif model == "poly3":
        (k1,) = params
        scale = k1 * r**2 + (1 - k1)
    else:
        scale = np.ones_like(r)
    return np.stack([cy + dy * scale / norm, cx + dx * scale / norm])


def lens_correction(img: np.ndarray, metadata: dict, profile: LensProfile | None = None) -> np.ndarray:
    """Distortion and vignetting correction of a planar (3, H, W) float
    image on the host; returns the input unchanged when the EXIF or a
    profile is missing."""
    if profile is None:
        profile = find_profile(metadata)
    if profile is None:
        _warn_missing_profile(metadata)
        return img
    try:
        focal = float(metadata["EXIF:FocalLength"])
        aperture = float(metadata["EXIF:FNumber"])
    except (KeyError, TypeError, ValueError):
        return img

    h, w = img.shape[-2:]
    out = np.asarray(img, np.float64)
    dist = profile.distortion_at(focal)
    if dist is not None:
        from raw2film_tpu_torch import native

        coords = undistort_coords((h, w), profile.dist_model, dist)
        remapped = native.remap_bilinear(np.asarray(out, np.float32), coords)
        if remapped is not None:
            out = remapped.astype(np.float64)
        else:
            from scipy import ndimage

            out = np.stack(
                [ndimage.map_coordinates(out[c], coords, order=1, mode="nearest") for c in range(out.shape[0])]
            )
        out = np.clip(out, 0.0, None)
    ks = profile.vignetting_at(focal, aperture)
    if ks is not None:
        out = out * vignetting_gain((h, w), ks)[None]
    return out.astype(np.float32)
