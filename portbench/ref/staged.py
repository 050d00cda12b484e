"""The plain reference of the CLI's default export: what ``raw2film-tpu-torch
<folder>`` with no flags renders for a DNG, before the file encode.

The staged half-size path, composed from the other reference files:

- the half-size decode, the camera matrix, the exposure estimate on the
  green plane and the aspect crop (``ref/preview.py::decoded``);
- the input matrix, clamped at 0;
- halation below the /4 mixture tier: the glow of the exponential kernel,
  then the combine ``(ep + f * blur) / (1 + f)``; from 40 px up, the /4
  tier of ``Ref.halation_developed``, as the full-size cells render it;
- development with the film's masking (``Ref.develop``);
- MTF with colour grain at the frame's pixels per mm (``Ref.mtf_grain``),
  the burn where the look has one, and ``print_encode``.

The grain seed is ``process_grain_seed(seed, 0)``: the CLI renders every
frame as image 0 of its own ``process()`` call.

One departure from the program, which follows upstream: upstream blurs
with the dense kernel (``cv2.filter2D`` of ``exponential_blur_kernel(size)``,
reflect-101 borders), and so does :func:`glow`, tap by tap. The program
factors the kernel by SVD and keeps the ranks above 1e-4 of the leading
singular value (at most 6 up to 12 px, at most 8 from 12 to 40 px), which it
runs on K2; what it drops is the comparison's to bound.

Float32 throughout, TF32 off; ``Ref(tf32=True)`` is the control, as in the
other cells. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.ref import preview as rprev
from portbench.ref import process as rproc
from portbench.ref.chain import Ref, exponential_blur_kernel, reflect_pad

MIXTURE_PX = 40.0  # above this glow size the /4 mixture tier renders the halation
CAP_PX_PER_MM = 400.0  # the CLI's max_scale: a decode above it is resized down first


def glow(ref: Ref, img: torch.Tensor, size: float) -> torch.Tensor:
    """The dense halation glow of (C, H, W) ``img``: the correlation with
    ``exponential_blur_kernel(size)`` in float32 over reflect-101 padding,
    summed tap by tap in row-major order (zero taps skipped)."""
    k = exponential_blur_kernel(size).astype(np.float32)
    r = k.shape[0] // 2
    h, w = img.shape[-2:]
    p = ref._q(reflect_pad(img, r, r))
    out = None
    for i in range(k.shape[0]):
        for j in range(k.shape[1]):
            if k[i, j] == 0.0:
                continue
            term = float(ref._q(torch.tensor(k[i, j])).item()) * p[..., i : i + h, j : j + w]
            out = term if out is None else out + term
    return out


def render(ref: Ref, xyz: torch.Tensor, film: dict, look: dict, seed: int) -> torch.Tensor:
    """(3, H, W) decoded XYZ -> (3, H, W) uint8, as the staged path renders
    it with ``look`` (``rproc.look`` at the decoded frame's scale)."""
    m = ref._q(film["m_in"])
    x = [ref._q(xyz[c]) for c in range(3)]
    ep = torch.stack([torch.clamp(m[i, 0] * x[0] + m[i, 1] * x[1] + m[i, 2] * x[2], min=0.0) for i in range(3)])
    size = look["scale"] / 4.0 * look["halation_size"]
    if look["halation"] and size <= MIXTURE_PX:
        g = film["hal_green"]
        f = (film["hal_intensity"] * torch.stack([torch.ones_like(g), g, torch.zeros_like(g)])).reshape(3, 1, 1)
        ep = (ep + f * glow(ref, ep, size)) / (1.0 + f)
        look = {**look, "halation": False}
    return ref.render_exposure(ep, film, look, seed)


def frame(ref: Ref, mosaic, norm, cam: np.ndarray, meta: dict, settings: dict, seed: int, device) -> torch.Tensor:
    """The (3, H, W) uint8 the CLI's default export renders for the DNG of
    RGGB ``mosaic`` with ``settings`` and grain ``seed`` (``--seed``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fw, fh = settings["frame_width"], settings["frame_height"]
    xyz = rprev.decoded(ref, mosaic, norm, cam, meta, fw / fh)
    scale = max(xyz.shape[-2:]) / max(fw, fh)
    if scale > CAP_PX_PER_MM:
        raise ValueError(f"{scale} px/mm is above the cap: its resize is not in this reference")
    film = rproc.film_params(settings, device)
    # ``look`` refuses a mask other than identity for the /4 tier's fused
    # development; below that tier ``Ref.develop`` applies any mask.
    below = scale / 4.0 * float(settings["halation_size"]) <= MIXTURE_PX or not settings["halation"]
    look = rproc.look({**settings, "color_masking": 1.0} if below else settings, film, scale)
    return render(ref, xyz, film, look, rproc.process_grain_seed(seed, 0))
