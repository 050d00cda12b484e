"""Settings persistence: profiles + per-image params + folder sidecars.

The reference persists edit state in QSettings JSON plus a per-folder
``raw2film_settings.json`` sidecar keyed by basename (reference:
src/raw2film/gui.py:2620-2701, 1840-1861). Same model here, minus Qt: a
JSON document {"profiles": {name: ProfileParams}, "images": {basename:
ImageParams}} with load/merge/save helpers.
"""

from __future__ import annotations

import dataclasses
import json
import os

from raw2film_tpu_torch.pipeline.params import ImageParams, ProfileParams

SIDECAR_NAME = "raw2film_settings.json"


def _to_dict(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else dict(obj)


def save_settings(
    path: str,
    profiles: dict[str, ProfileParams | dict] | None = None,
    images: dict[str, ImageParams | dict] | None = None,
) -> None:
    doc = {
        "profiles": {k: _to_dict(v) for k, v in (profiles or {}).items()},
        "images": {k: _to_dict(v) for k, v in (images or {}).items()},
        "version": 1,
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


# Per-image keys the reference stores OUTSIDE its default schema dicts and
# persists wholesale in settings JSON (gui.py:1716-1729, 1865-1873): manual
# camera/lens overrides + the per-image lens-correction toggle. Preserved
# through sidecar round-trips alongside the ImageParams schema keys.
DYNAMIC_IMAGE_KEYS = ("lens", "lens_correction", "cam")


def load_settings(path: str) -> tuple[dict, dict]:
    """-> (profiles: name->dict, images: basename->dict), each filtered to
    its schema keys (plus :data:`DYNAMIC_IMAGE_KEYS` for images). Unknown
    keys are ignored so documents from other versions load; values are
    plain dicts so dynamic keys survive a round trip."""
    with open(path) as f:
        doc = json.load(f)
    prof_fields = {f.name for f in dataclasses.fields(ProfileParams)}
    img_fields = {f.name for f in dataclasses.fields(ImageParams)}
    profiles = {
        name: {k: v for k, v in p.items() if k in prof_fields}
        for name, p in doc.get("profiles", {}).items()
    }
    images = {
        name: {
            k: v
            for k, v in p.items()
            if k in img_fields or k in DYNAMIC_IMAGE_KEYS
        }
        for name, p in doc.get("images", {}).items()
    }
    return profiles, images


def sidecar_path(folder: str) -> str:
    return os.path.join(folder, SIDECAR_NAME)


def load_folder_settings(folder: str) -> tuple[dict, dict]:
    p = sidecar_path(folder)
    if os.path.exists(p):
        return load_settings(p)
    return {}, {}
