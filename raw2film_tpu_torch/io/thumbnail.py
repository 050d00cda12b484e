"""Fast thumbnails for browsers/strips.

The reference's image bar lazily decodes embedded thumbnails via rawpy
``extract_thumb`` for visible items only (reference:
src/raw2film/image_bar.py:97-113, 428-435). DNGs written by cameras embed a
JPEG preview in IFD0; this reader grabs it when present, else falls back to
a fast half-size decode + display tonemap.
"""

from __future__ import annotations

import io as _io

import numpy as np

from raw2film_tpu_torch.data import XYZ_TO_REC709


def extract_thumb(src: str, max_edge: int = 256, device=None) -> np.ndarray:
    """-> uint8 (h, w, 3) thumbnail. ``device``: where the fallback decode
    runs (the caller's Processor's device; by default the first CUDA
    device, as ``raw_to_linear``'s)."""
    from PIL import Image

    # 0) CR3: the CRX payload is undecodable here, but the ISO-BMFF
    # container carries PRVW/THMB JPEGs (io/cr3.py) — browsing works.
    if str(src).lower().endswith(".cr3"):
        try:
            from raw2film_tpu_torch.io import cr3

            with open(src, "rb") as f:
                buf = f.read()
            jpg = cr3.extract_preview(buf) if cr3.is_cr3(buf) else None
            if jpg:
                with Image.open(_io.BytesIO(jpg)) as im:
                    orient = cr3.extract_metadata(buf).get("EXIF:Orientation", 1)
                    if orient in (3, 6, 8):
                        im = im.rotate({3: 180, 6: -90, 8: 90}[orient], expand=True)
                    im.thumbnail((max_edge, max_edge))
                    return np.asarray(im.convert("RGB"))
        except Exception:
            pass

    # 0a) CRW: the CIFF heap's JPEG thumbnail (tag 0x2007) — raw decode is
    # unsupported but browsing works, like CR3.
    if str(src).lower().endswith(".crw"):
        try:
            from raw2film_tpu_torch.io import crw

            with open(src, "rb") as f:
                buf = f.read()
            jpg = crw.extract_preview(buf)
            if jpg:
                with Image.open(_io.BytesIO(jpg)) as im:
                    im.thumbnail((max_edge, max_edge))
                    return np.asarray(im.convert("RGB"))
        except Exception:
            pass

    # 0b) RAF: the embedded preview JPEG (PIL cannot open the RAF
    # container itself).
    if str(src).lower().endswith(".raf"):
        try:
            from PIL import ImageOps

            from raw2film_tpu_torch.io import raf

            with open(src, "rb") as f:
                buf = f.read()
            jpg = raf.extract_preview(buf)
            if jpg:
                with Image.open(_io.BytesIO(jpg)) as im:
                    im = ImageOps.exif_transpose(im)
                    im.thumbnail((max_edge, max_edge))
                    return np.asarray(im.convert("RGB"))
        except Exception:
            pass

    # 1) embedded JPEG preview (PIL reads TIFF-wrapped JPEG thumbnails for
    # many DNGs; our own synthetic DNGs have none).
    try:
        from PIL import ImageOps

        with Image.open(src) as im:
            im = ImageOps.exif_transpose(im)  # upright per Orientation tag
            im.thumbnail((max_edge, max_edge))
            return np.asarray(im.convert("RGB"))
    except Exception:
        pass

    # 2) half-size decode + quick sRGB tonemap.
    from raw2film_tpu_torch.io.raw import raw_to_linear

    xyz, _ = raw_to_linear(src, half_size=True, device=device)
    xyz = xyz.cpu().numpy()
    rgb = np.einsum("ij,jhw->ihw", XYZ_TO_REC709, xyz)
    rgb = np.clip(rgb, 0.0, 1.0) ** (1 / 2.2)
    h, w = rgb.shape[-2:]
    step = max(1, int(np.ceil(max(h, w) / max_edge)))
    small = rgb[:, ::step, ::step]
    return (small.transpose(1, 2, 0) * 255).astype(np.uint8)
