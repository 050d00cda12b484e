"""Carry the JAX package's film bundle and render config across to the port.

``bundle_from_numpy`` takes the JAX bundle dict (its leaves as numpy arrays,
``np.asarray`` of each) and gives the port's bundle of float32 tensors;
``config_from_jax`` maps a JAX ``RenderConfig`` to the port's, dropping the
fields that exist only for the TPU's scoped-VMEM ladder (``fusion``,
``conservative_tiles``). Neither imports JAX: they read attributes and
arrays only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raw2film_tpu_torch.ops.develop import host_params
from raw2film_tpu_torch.ops.print_encode import PVEC_KEYS
from raw2film_tpu_torch.pipeline.render import RenderConfig, host_m_in, host_print_vec


DEVELOP_KEYS = ("flare", "neg_curve", "d_min", "mask")  # host_params's arguments


def bundle_from_numpy(jax_bundle: dict, device=None) -> dict:
    """JAX bundle dict -> dict of float32 tensors on ``device``; tuple
    leaves (the H&D curves) stay tuples. Like ``make_film_bundle``'s, a
    bundle with ``m_in`` also holds ``m_in_host``, its copy on the host, and
    one with the print parameters ``pvec_host``, their packed host copy, and
    one with the development's ``develop_host``, theirs."""

    def leaf(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    out = {
        k: tuple(leaf(a) for a in v) if isinstance(v, tuple) else leaf(v)
        for k, v in jax_bundle.items()
    }
    if "m_in" in jax_bundle:
        out["m_in_host"] = host_m_in(np.asarray(jax_bundle["m_in"]))
    if all(k in jax_bundle for k in PVEC_KEYS):
        out["pvec_host"] = host_print_vec(jax_bundle)
    if all(k in jax_bundle for k in DEVELOP_KEYS):
        out["develop_host"] = host_params(*(jax_bundle[k] for k in DEVELOP_KEYS))
    return out


def config_from_jax(cfg) -> RenderConfig:
    """JAX RenderConfig -> the port's RenderConfig (same field values)."""
    names = {f.name for f in dataclasses.fields(RenderConfig)}
    return RenderConfig(**{k: getattr(cfg, k) for k in names})
