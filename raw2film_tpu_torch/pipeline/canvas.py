"""Canvas / border composition (host, export-time).

Reference semantics: modes No / Proportional / Uniform / Fixed x white/black
(src/raw2film/effects.py:290-357, modes raw_conversion.py:21-29).
"""

from __future__ import annotations

import numpy as np


def get_canvas_data(
    shape: tuple[int, ...],
    canvas_mode: str,
    canvas_scale: float = 1.0,
    canvas_ratio: float = 1.0,
):
    """-> (output_resolution (H, W), color (r, g, b), offset (y, x))."""
    if "white" in canvas_mode:
        color = (255, 255, 255)
    elif "black" in canvas_mode:
        color = (0, 0, 0)
    else:
        color = (128, 128, 128)

    h, w = shape[:2]
    if "Proportional" in canvas_mode:
        ratio = w / h  # proportional: border keeps the image's own ratio
        out = (int(h * canvas_scale), int(h * ratio * canvas_scale)) if w / h <= ratio else (
            int(w / ratio * canvas_scale),
            int(w * canvas_scale),
        )
    elif "Fixed" in canvas_mode:
        if w / h > canvas_ratio:
            out = (int(w / canvas_ratio * canvas_scale), int(w * canvas_scale))
        else:
            out = (int(h * canvas_scale), int(h * canvas_ratio * canvas_scale))
    elif "Uniform" in canvas_mode:
        border = int(max(h, w) * (canvas_scale - 1.0))
        out = (h + border, w + border)
    else:
        return (h, w), color, np.zeros(2, int)
    offset = (np.asarray(out) - np.asarray((h, w))) // 2
    return out, color, offset


def add_canvas(
    image_hwc: np.ndarray,
    canvas_mode: str = "No",
    canvas_scale: float = 1.0,
    canvas_ratio: float = 1.0,
) -> np.ndarray:
    """uint8 (H, W, 3) -> padded onto the canvas color."""
    if canvas_mode == "No":
        return image_hwc
    out_res, color, off = get_canvas_data(
        image_hwc.shape, canvas_mode, canvas_scale, canvas_ratio
    )
    canvas = np.empty((*out_res, 3), np.uint8)
    canvas[:] = np.asarray(color, np.uint8)
    canvas[
        off[0] : off[0] + image_hwc.shape[0], off[1] : off[1] + image_hwc.shape[1]
    ] = image_hwc
    return canvas
