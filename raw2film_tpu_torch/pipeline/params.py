"""Typed parameter schema: the render-facing settings surface.

The reference merges three dicts (defaults -> profile -> per-image,
reference: src/raw2film/gui.py:486-531, 2181-2195) whose union is the
``process()`` kwargs schema. Here that schema is two frozen dataclasses with
the same field names and defaults, so reference settings JSONs port over
1:1. ``ProfileParams`` + ``ImageParams`` hash into the jit cache key via
their *static* subset (toggles and kernel-shaping values); continuously
varying values travel as traced arrays and never retrigger compilation.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, replace


@dataclass(frozen=True)
class ProfileParams:
    """Per-profile settings (reference dflt_prf_params, gui.py:486-515)."""

    negative_film: str = "Kodak Portra 400"
    print_film: str | None = "Fuji Crystal Archive Maxima"
    red_light: float = 0.0
    green_light: float = 0.0
    blue_light: float = 0.0
    halation: bool = True
    sharpness: bool = True
    grain: int = 2  # 0 off, 1 BW (shared field), 2 color
    film_format: str = "135"
    frame_width: float = 36.0
    frame_height: float = 24.0
    grain_size: float = 6.0  # micrometres
    halation_size: float = 1.0
    halation_green_factor: float = 0.3
    projector_kelvin: float = 6500.0
    inversion_gamma: float = 4.0
    idealized_curve: bool = False
    halation_intensity: float = 1.0
    shadow_comp: float = 0.0
    white_clip: bool = False
    white_balance: bool = False
    sat_adjust: float = 1.0
    grain_sigma: float = 0.4
    gamma_func: str = "sRGB"
    push_pull: float = 0.0
    sharpening_strength: float = 0.0
    sharpening_sigma: float = 1.0
    color_masking: float = 1.0
    # r2f-only extension (not in the reference schema): build the MTF
    # kernel without the reference's np.abs() rectification so the applied
    # sharpness tracks the tabulated datasheet response. Off by default to
    # preserve reference-parity output (see ops/mtf.py::mtf_kernel_layer).
    mtf_fidelity: bool = False


@dataclass(frozen=True)
class ImageParams:
    """Per-image settings (reference dflt_img_params, gui.py:516-531)."""

    exp_comp: float = 0.0
    zoom: float = 1.0
    rotate_times: int = 0
    rotation: float = 0.0
    exp_kelvin: float = 6000.0
    profile: str = "Default"
    canvas_mode: str = "No"
    canvas_scale: float = 1.0
    canvas_ratio: float = 0.8
    highlight_burn: float = 0.0
    burn_scale: float = 50.0
    flip: bool = False
    tint: float = 0.0
    chroma_nr: int = 0


def apply_film_format(merged: dict) -> dict:
    """Resolve ``film_format`` (a FORMATS frame-size name) into
    frame_width/height in place; explicit frame dims win when the user moved
    them off the 135 default (reference FORMATS table, data.py)."""
    fmt = merged.pop("film_format", None)
    if fmt:
        from raw2film_tpu_torch.data import FORMATS

        if fmt in FORMATS and (
            merged.get("frame_width", 36.0) == 36.0
            and merged.get("frame_height", 24.0) == 24.0
        ):
            merged["frame_width"], merged["frame_height"] = FORMATS[fmt]
    return merged


def merge_params(
    profile_params: ProfileParams | dict | None = None,
    image_params: ImageParams | dict | None = None,
    **overrides,
) -> dict:
    """Flatten (profile, image, overrides) into one kwargs dict, the same
    merge the reference performs at render time (gui.py:2181-2195)."""
    out = asdict(ProfileParams())
    out.update(asdict(ImageParams()))
    for layer in (profile_params, image_params):
        if layer is None:
            continue
        if hasattr(layer, "__dataclass_fields__"):
            layer = asdict(layer)
        out.update({k: v for k, v in layer.items() if k in out})
    out.update({k: v for k, v in overrides.items() if k in out})
    return out
