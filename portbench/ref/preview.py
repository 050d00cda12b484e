"""The plain reference of a preview frame: what ``PreviewEngine`` hands to
``on_frame`` for a DNG at the viewer's settings (the half-size decode, the
cap in pixels per mm, the simplified look: no halation, MTF or grain), and
its histogram strip.

Written for this benchmark from the program's staged path as it stood when
the benchmark was added: the half-size decode and camera matrix, the
exposure estimate, the aspect crop, the antialiased linear resize to the
cap, the development and print, the Lanczos-5 resize back to the decoded
size with the clip and truncation to uint8, and the histogram's counts and
strip. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.ref import process as rproc

F32 = np.float32
_EPS32 = float(np.finfo(np.float32).eps)


def _triangle(x):
    return np.maximum(F32(0.0), F32(1.0) - np.abs(x))


def _lanczos5(x):
    radius, pi = F32(5.0), F32(np.pi)
    y = radius * np.sin(pi * x) * np.sin(pi * x / radius)
    safe = np.where(x != 0, F32(np.pi**2) * (x * x), F32(1.0))
    out = np.where(x > F32(1e-3), y / safe, F32(1.0))
    return np.where(x > radius, F32(0.0), out).astype(F32)


def weight_matrix(n_in: int, n_out: int, method: str, antialias: bool = True) -> np.ndarray:
    """(n_in, n_out) float32 weights of one axis, as ``jax.image.resize``."""
    kernel = {"linear": _triangle, "lanczos5": _lanczos5}[method]
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = F32(max(inv_scale, 1.0)) if antialias else F32(1.0)
    sample = (np.arange(n_out, dtype=F32) + F32(0.5)) * F32(inv_scale) - F32(0.0) - F32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=F32)[:, None]) / kernel_scale
    w = kernel(x).astype(F32)
    total = w.sum(axis=0, keepdims=True, dtype=F32)
    w = np.where(np.abs(total) > F32(1000.0 * _EPS32), w / np.where(total != 0, total, F32(1.0)), F32(0.0))
    inside = (sample >= F32(-0.5)) & (sample <= F32(n_in - 0.5))
    return np.where(inside[None, :], w, F32(0.0)).astype(F32)


def resize(ref, img, out_hw, method: str, antialias: bool = True):
    h, w = img.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = img
    if oh != h:
        out = ref.matmul(torch.tensor(weight_matrix(h, oh, method, antialias).T, device=img.device), out)
    if ow != w:
        out = ref.matmul(out, torch.tensor(weight_matrix(w, ow, method, antialias), device=img.device))
    return out


def fit(ref, img, resolution):
    """Scaled to fit ``resolution``: the antialiased linear resize to
    shrink, Lanczos-5 to enlarge (the frames here are no integer shrink)."""
    _, h, w = img.shape
    factor = min(resolution[0] / h, resolution[1] / w)
    if abs(factor - 1.0) < 1e-9:
        return img
    out_hw = (round(h * factor), round(w * factor))
    if factor < 1.0:
        inv = 1.0 / factor
        if abs(inv - round(inv)) < 1e-9 and h % round(inv) == 0 and w % round(inv) == 0:
            raise ValueError("an integer shrink is not in the reference")
        return resize(ref, img, out_hw, "linear")
    return resize(ref, img, out_hw, "lanczos5")


def decoded(ref, mosaic, norm, cam: np.ndarray, meta: dict, aspect: float):
    """(3, h, w) XYZ of the half-size decode at mid-grey exposure, cropped
    to the frame's aspect (the preview's cached decode)."""
    black, inv_range = (float(v) for v in np.asarray(norm, np.float32).reshape(2))
    x = torch.clamp((mosaic.to(torch.float32) - black) * inv_range, 0.0, 1.0)
    h2, w2 = x.shape[0] // 2, x.shape[1] // 2
    x = x[: h2 * 2, : w2 * 2]
    rgb = torch.clamp(torch.stack([x[0::2, 0::2], 0.5 * (x[0::2, 1::2] + x[1::2, 0::2]), x[1::2, 1::2]]), 0.0, 1.0)
    mt = [[float(v) for v in row] for row in ref._q(torch.tensor(cam)).numpy()]
    rgb = ref._q(rgb)
    xyz = torch.stack([mt[i][0] * rgb[0] + mt[i][1] * rgb[1] + mt[i][2] * rgb[2] for i in range(3)])
    lum = xyz[1, ::2, ::2].cpu().numpy()
    xyz = xyz * (2.0 ** rproc.exposure_stops(lum, meta))
    rows, cols = rproc.aspect_crop(xyz.shape[1], xyz.shape[2], aspect)
    return xyz[:, rows, cols].contiguous()


def frame(ref, xyz, settings: dict, max_scale: float, exp_comp: float, device):
    """One preview: (the (H, W, 3) uint8 image, the (100, 256, 4) strip)."""
    s = {**settings, "exp_comp": exp_comp, "halation": False, "sharpness": False, "grain": 0}
    h, w = xyz.shape[-2:]
    fw, fh = s["frame_width"], s["frame_height"]
    res = (h, w)
    scale = max(res) / max(fw, fh)
    if scale > max_scale:
        f = max_scale / scale
        res = (round(h * f), round(w * f))
    small = fit(ref, xyz, res).contiguous()
    film = rproc.film_params(s, device)
    look = rproc.look(s, film, max(small.shape[-2:]) / max(fw, fh))
    m = ref._q(film["m_in"])
    x = [ref._q(small[c]) for c in range(3)]
    ep = torch.stack([torch.clamp(m[i, 0] * x[0] + m[i, 1] * x[1] + m[i, 2] * x[2], min=0.0) for i in range(3)])
    out = ref.render_exposure(ep, film, look, 0)
    back = fit(ref, out.to(torch.float32), (h, w)).cpu().numpy()
    image = np.clip(back, 0, 255).astype(np.uint8).transpose(1, 2, 0)
    return image, strip(counts(torch.as_tensor(np.ascontiguousarray(image.transpose(2, 0, 1)), device=device)))


def counts(img_u8, max_samples: int = 1 << 19) -> np.ndarray:
    h, w = img_u8.shape[-2:]
    stride = int(np.ceil(np.sqrt(max(h * w / max_samples, 1.0))))
    flat = img_u8[:, ::stride, ::stride].reshape(3, -1).to(torch.int64)
    c = torch.stack([torch.bincount(flat[i], minlength=256) for i in range(3)])
    return (c.to(torch.float32) * float(stride * stride)).cpu().numpy()


def _mix_table() -> np.ndarray:
    lin = [(np.asarray(c, np.float32) / 255.0) ** 2.2 for c in ([235.0, 90.0, 80.0], [80.0, 200.0, 90.0], [95.0, 110.0, 235.0])]
    table = np.zeros((2, 2, 2, 4), np.uint8)
    for r in (0, 1):
        for g in (0, 1):
            for b in (0, 1):
                if r or g or b:
                    mix = np.clip(r * lin[0] + g * lin[1] + b * lin[2], 0, 1)
                    table[r, g, b, :3] = np.round(mix ** (1 / 2.2) * 255)
                    table[r, g, b, 3] = 255
    peak = (table[1, 1, 1, :3] / 255.0) ** 2.2
    table[1, 1, 1, :3] = int(round(peak.mean() ** (1 / 2.2) * 255))
    return table


def strip(c: np.ndarray, height: int = 100) -> np.ndarray:
    """(3, 256) counts -> the (height, 256, 4) uint8 strip."""
    f = np.log1p(c / max(float(c.max()), 1.0))
    sm = np.empty_like(f)
    sm[:, 1:-1] = (f[:, :-2] + f[:, 1:-1] + f[:, 2:]) / 3
    sm[:, 0] = (2 * f[:, 0] + f[:, 1]) / 3
    sm[:, -1] = (2 * f[:, -1] + f[:, -2]) / 3
    bars = (sm * height / max(float(sm.max()), 1e-9)).astype(np.int32)
    act = (np.arange(height)[:, None] >= (height - bars[:, None, :])).astype(np.int32)
    return _mix_table()[act[0], act[1], act[2]]
