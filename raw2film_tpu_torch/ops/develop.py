"""K16: the development, (3, H, W) exposure to status density, in one pass.

No TPU kernel stands behind it: on the TPU, XLA fuses the develop section of
``raw2film_tpu/pipeline/render.py`` into one elementwise pass. Its plain
version is the chain's own development, ``pipeline/render.py::_develop_plain``;
``render.py::_develop`` chooses between the two by ``kb.use_kernel``.

The kernel takes the film's development parameters by value from the
bundle's ``develop_host`` (:func:`host_params`), a host copy built with the
bundle, so a launch copies nothing to or from the device.
"""

from __future__ import annotations

import numpy as np
import torch

from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.utils import trace

# [flare, the curve's d_min*3, gamma*3, x_toe*3, x_shoulder*3, w_toe*3,
# w_shoulder*3, the bundle's d_min*3, mask*9 (row-major)]: r2f::dev::PARAMS.
# The first 19 are K14's develop vector (ops/halation.py::develop_vector).
PARAMS = 31


def host_params(flare, neg_curve, d_min, mask) -> np.ndarray:
    """The bundle's ``develop_host``: a read-only float32 numpy copy of the
    development's parameters in K16's order, from the host arrays the
    bundle's ``flare``, ``neg_curve``, ``d_min`` and ``mask`` are made from."""
    parts = [flare, *neg_curve, d_min, mask]
    vec = np.concatenate([np.asarray(p, np.float32).reshape(-1) for p in parts])
    if vec.size != PARAMS:
        raise ValueError(f"develop parameters: {vec.size} floats, want {PARAMS}")
    vec.setflags(write=False)
    return vec


def develop(ep: torch.Tensor, params: np.ndarray) -> torch.Tensor:
    """K16 wrapper: (3, H, W) float32 contiguous exposure on the current CUDA
    device -> (3, H, W) density; ``params`` the bundle's ``develop_host``.
    The C entry point takes 16-byte loads and stores where H * W % 4 == 0
    and both buffers are 16-byte aligned. Recorded as the device span
    ``kernel.develop``."""
    with trace.stage_timer("kernel.develop", device=ep):
        kb.require(ep, "exposure", torch.float32)
        if ep.dim() != 3 or ep.shape[0] != 3:
            raise ValueError(f"exposure: want (3, H, W), got {tuple(ep.shape)}")
        if params.dtype != np.float32 or params.shape != (PARAMS,) or not params.flags.c_contiguous:
            raise ValueError(f"develop parameters: want float32 ({PARAMS},)")
        _, h, w = ep.shape
        out = torch.empty_like(ep)
        err = kb.lib().r2f_develop(ep.data_ptr(), out.data_ptr(), params.ctypes.data, h, w, kb.stream_ptr(ep))
        kb.check(err, "r2f_develop")
        trace.count("launch.develop")
        return out
