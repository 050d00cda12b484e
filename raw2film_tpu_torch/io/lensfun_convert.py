"""lensfun XML -> raw2film-tpu JSON lens-profile converter (host, offline).

The reference ships lensfun's full camera/lens database via lensfunpy
(reference: src/raw2film/effects.py:22-43, gui.py:556-563). This framework
reads a JSON database (io/lens.py); this module converts an installed
lensfun database — e.g. /usr/share/lensfun/version_*/ or a checkout of
github.com/lensfun/lensfun/data/db — into that format:

    raw2film-tpu --import-lensfun /usr/share/lensfun

Distortion: prefers per-focal ``ptlens`` rows, falls back to ``poly3``.
Vignetting: ``pa`` model rows (focal, aperture, k1..k3). Other calibration
types (tca, acm) have no consumer in the pipeline and are skipped.
"""

from __future__ import annotations

import glob
import json
import os
import xml.etree.ElementTree as ET


def _text(el, tag: str, default: str = "") -> str:
    """First <tag> child's text, preferring entries without a lang attr
    (lensfun localizes maker/model with lang='xx' variants)."""
    best = None
    for child in el.findall(tag):
        if child.get("lang") in (None, "en"):
            return (child.text or "").strip()
        best = best if best is not None else (child.text or "").strip()
    return best if best is not None else default


def _lens_to_profile(lens) -> dict | None:
    model = _text(lens, "model")
    maker = _text(lens, "maker")
    if not model:
        return None
    calib = lens.find("calibration")
    dist_ptlens, dist_poly3, vig = [], [], []
    if calib is not None:
        for d in calib.findall("distortion"):
            try:
                focal = float(d.get("focal"))
            except (TypeError, ValueError):
                continue
            m = d.get("model")
            if m == "ptlens":
                dist_ptlens.append(
                    (
                        focal,
                        float(d.get("a", 0.0)),
                        float(d.get("b", 0.0)),
                        float(d.get("c", 0.0)),
                    )
                )
            elif m == "poly3":
                dist_poly3.append((focal, float(d.get("k1", 0.0))))
        for v in calib.findall("vignetting"):
            if v.get("model") != "pa":
                continue
            try:
                vig.append(
                    (
                        float(v.get("focal")),
                        float(v.get("aperture")),
                        float(v.get("k1", 0.0)),
                        float(v.get("k2", 0.0)),
                        float(v.get("k3", 0.0)),
                    )
                )
            except (TypeError, ValueError):
                continue
    if dist_ptlens:
        dist_model, dist_params = "ptlens", sorted(dist_ptlens)
    elif dist_poly3:
        dist_model, dist_params = "poly3", sorted(dist_poly3)
    else:
        dist_model, dist_params = "none", []
    if dist_model == "none" and not vig:
        return None  # nothing the pipeline can use
    try:
        crop = float(_text(lens, "cropfactor", "1.0") or 1.0)
    except ValueError:
        crop = 1.0
    return {
        "make": maker,
        "model": model,
        "mount": _text(lens, "mount"),
        "crop_factor": crop,
        "dist_model": dist_model,
        "dist_params": dist_params,
        "vig_params": sorted(vig),
        # lensfun rows are community-measured calibrations: they outrank
        # the vendored class-derived catalog in find_profile.
        "confidence": "measured",
    }


def convert_lensfun_xml(path: str) -> list[dict]:
    """One lensfun XML file -> list of profile dicts."""
    root = ET.parse(path).getroot()
    out = []
    for lens in root.findall("lens"):
        prof = _lens_to_profile(lens)
        if prof is not None:
            out.append(prof)
    return out


def convert_lensfun_db(src: str, out_json: str | None = None) -> list[dict]:
    """Convert a lensfun DB directory (searched recursively for *.xml) or a
    single XML file; optionally write the JSON database raw2film-tpu loads
    (~/.raw2film_tpu/lenses.json by default convention)."""
    if os.path.isdir(src):
        files = sorted(glob.glob(os.path.join(src, "**", "*.xml"), recursive=True))
    else:
        files = [src]
    profiles: list[dict] = []
    for f in files:
        try:
            profiles.extend(convert_lensfun_xml(f))
        except ET.ParseError:
            continue
    if out_json:
        os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
        with open(out_json, "w") as fh:
            json.dump(profiles, fh)
    return profiles
