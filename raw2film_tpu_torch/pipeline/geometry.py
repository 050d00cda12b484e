"""Host-side geometry preprocessing: crop to aspect, rotate, zoom, flip.

The reference performs all geometry on the CPU before the pixel engines run
(reference: src/raw2film/gpu_processor.py:715-783 extract_image_data_cpu;
crop/rotate math in src/raw2film/effects.py:46-111 and
raw_conversion.py:56-72). We keep the same placement: geometry happens once
per image at load time on host (planar float32), the film chain runs on
device. Arbitrary-angle rotation uses OpenCV when available, else a scipy
fallback.
"""

from __future__ import annotations

import math

import numpy as np


def crop_to_aspect(img: np.ndarray, aspect: float = 1.5, flip: bool = False) -> np.ndarray:
    """Center-crop planar (C, H, W) to the given aspect = long/short ratio
    (reference semantics: src/raw2film/effects.py:77-103)."""
    _, x, y = img.shape
    if flip:
        aspect = 1.0 / aspect
    if x > y:
        if x > aspect * y:
            lo = math.ceil(x / 2 - y * aspect / 2)
            hi = math.ceil(x / 2 + y * aspect / 2)
            img = img[:, lo:hi, :]
        else:
            lo = math.ceil(y / 2 - x / aspect / 2)
            hi = math.ceil(y / 2 + x / aspect / 2)
            img = img[:, :, lo:hi]
    elif y > aspect * x:
        lo = math.ceil(y / 2 - x * aspect / 2)
        hi = math.ceil(y / 2 + x * aspect / 2)
        img = img[:, :, lo:hi]
    else:
        lo = math.ceil(x / 2 - y / aspect / 2)
        hi = math.ceil(x / 2 + y / aspect / 2)
        img = img[:, lo:hi, :]
    return img


def zoom_crop(img: np.ndarray, zoom: float) -> np.ndarray:
    """Symmetric crop implementing zoom > 1
    (reference: src/raw2film/effects.py:104-109)."""
    if zoom <= 1.0:
        return img
    _, x, y = img.shape
    zf = (zoom - 1.0) / (2.0 * zoom)
    cx = math.ceil(zf * x)
    cy = math.ceil(zf * y)
    return img[:, cx : x - cx, cy : y - cy]


def _largest_rotated_rect(w: int, h: int, angle_rad: float) -> tuple[float, float]:
    """Largest axis-aligned rectangle with the original aspect inside a
    w x h frame rotated by angle (the reference's auto-crop,
    src/raw2film/effects.py:53-67 expressed directly)."""
    aspect = h / w
    a = abs(angle_rad)
    if aspect < 1:
        total = h
        ar = 1.0 / aspect
        switch = True
    else:
        total = w
        ar = aspect
        switch = False
    cw = total / (ar * math.sin(a) + math.cos(a))
    ch = cw * ar
    if switch:
        cw, ch = ch, cw
    return cw, ch


def rotate(img: np.ndarray, degrees: float) -> np.ndarray:
    """Rotate planar (C, H, W) by ``degrees`` with bilinear resampling, then
    auto-crop to hide the corners."""
    if not degrees:
        return img
    c, h, w = img.shape
    try:
        import cv2 as cv

        mat = cv.getRotationMatrix2D((w / 2, h / 2), -degrees, 1.0)
        hwc = np.ascontiguousarray(img.transpose(1, 2, 0))
        rot = cv.warpAffine(hwc, mat, (w, h), flags=cv.INTER_LINEAR)
        rot = rot.transpose(2, 0, 1)
    except ImportError:
        from scipy import ndimage

        rot = np.stack(
            [ndimage.rotate(img[i], degrees, reshape=False, order=1) for i in range(c)]
        )
    cw, ch = _largest_rotated_rect(w, h, math.radians(degrees))
    crop_h = int((h - ch) // 2)
    crop_w = int((w - cw) // 2)
    if crop_h > 0:
        rot = rot[:, crop_h : h - crop_h, :]
    if crop_w > 0:
        rot = rot[:, :, crop_w : w - crop_w]
    return np.ascontiguousarray(rot)


def crop_rotate_zoom(
    img: np.ndarray,
    frame_width: float = 36.0,
    frame_height: float = 24.0,
    rotation: float = 0.0,
    zoom: float = 1.0,
    rotate_times: int = 0,
    flip: bool = False,
) -> np.ndarray:
    """Full geometry preprocessing pass, planar (C, H, W)
    (reference order: src/raw2film/raw_conversion.py:56-72)."""
    img = crop_to_aspect(img, aspect=frame_width / frame_height, flip=flip)
    if rotation:
        img = rotate(img, rotation)
    img = crop_to_aspect(img, aspect=frame_width / frame_height)
    img = zoom_crop(img, zoom)
    if rotate_times:
        img = np.rot90(img, k=rotate_times, axes=(1, 2))
    return np.ascontiguousarray(img)
