"""ICC display / soft-proof transforms.

The reference applies an ICC transform by baking it into the 33^3 output LUT
through LittleCMS (reference: src/raw2film/cpu_processor.py:255-263,
gui.py:2771-2934 for display/softproof setup) — the image itself never pays
for color management. Here the same bake targets either a tabulated output
LUT or a post-render uint8 image, through PIL's ImageCms when available
(gracefully unavailable otherwise).
"""

from __future__ import annotations

import numpy as np


def have_icc() -> bool:
    try:
        from PIL import ImageCms  # noqa: F401

        return True
    except ImportError:
        return False


def build_transform(display_profile_path: str, intent: int = 0):
    """sRGB -> display-profile transform (None if ICC support is missing)."""
    try:
        from PIL import ImageCms
    except ImportError:
        return None
    srgb = ImageCms.createProfile("sRGB")
    dst = ImageCms.getOpenProfile(display_profile_path)
    return ImageCms.buildTransform(
        srgb, dst, "RGB", "RGB", renderingIntent=intent
    )


def build_softproof_transform(
    proof_profile_path: str, display_profile_path: str | None = None, intent: int = 0
):
    try:
        from PIL import ImageCms
    except ImportError:
        return None
    srgb = ImageCms.createProfile("sRGB")
    proof = ImageCms.getOpenProfile(proof_profile_path)
    dst = (
        ImageCms.getOpenProfile(display_profile_path)
        if display_profile_path
        else srgb
    )
    return ImageCms.buildProofTransform(
        srgb, dst, proof, "RGB", "RGB", renderingIntent=intent
    )


def apply_transform_to_lut(lut: np.ndarray, transform) -> np.ndarray:
    """Bake an ICC transform into a (N, N, N, 3) float LUT (the reference's
    cheap-LUT-not-image strategy, cpu_processor.py:255-263).

    ``transform`` may also be a plain callable mapping a float [0,1] RGB
    array to another — the float-precision hook used for custom transforms
    and tests.
    """
    if transform is None:
        return lut
    if callable(transform) and not hasattr(transform, "transform"):
        return np.asarray(transform(lut), np.float32)
    from PIL import Image, ImageCms

    shape = lut.shape
    u8 = (np.clip(lut, 0, 1) * 255).astype(np.uint8).reshape(shape[0], -1, 3)
    img = Image.fromarray(u8)
    ImageCms.applyTransform(img, transform, inPlace=True)
    return (np.asarray(img, np.uint8).reshape(shape) / 255.0).astype(np.float32)


def bake_output_cp(transform, n: int = 33, rank: int = 24):
    """Tabulate an ICC/display transform over the encoded-RGB cube and
    CP-factor it for the gather-free device apply.

    Returns (u, v, w_bc, max_abs_err) for ops.lut.apply_lut_3d_cp — the
    image itself never pays for color management (reference property,
    cpu_processor.py:255-263), and the transform runs BEFORE the final
    8-bit quantization (no double quantization).
    """
    from raw2film_tpu_torch.ops.lut import fit_lut3d_cp

    g = np.linspace(0.0, 1.0, n, dtype=np.float32)
    grid = np.stack(
        np.meshgrid(g, g, g, indexing="ij"), axis=-1
    )  # (n, n, n, 3) identity LUT in encoded RGB
    baked = apply_transform_to_lut(grid, transform)
    return fit_lut3d_cp(baked, rank=rank)


def apply_transform_to_image(image_hwc_u8: np.ndarray, transform) -> np.ndarray:
    if transform is None:
        return image_hwc_u8
    from PIL import Image, ImageCms

    img = Image.fromarray(np.ascontiguousarray(image_hwc_u8))
    ImageCms.applyTransform(img, transform, inPlace=True)
    return np.asarray(img, np.uint8)
