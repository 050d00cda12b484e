"""Device mesh and sharded batch rendering.

The counterpart of ``raw2film_tpu/parallel/mesh.py``, written as PyTorch
rather than ``shard_map``: a :class:`Mesh` is a (batch, space) grid of
``torch.device``s, and :func:`sharded_batch_render` is a loop that launches
each shard's render on its own device. Launches are asynchronous, so
shards on different GPUs overlap; on one card a mesh may repeat a device
(``make_mesh(devices=[cuda:0] * 4)``, the counterpart of the JAX tests'
virtual CPU devices), and its shards then run one after another.

- The batch axis: image b goes to batch row ``b % batch``.
- The space axis (the halo path): one frame's rows are split over the
  row's devices. Each shard takes its rows plus a halo of neighbour rows
  (:func:`space_halo_rows`) in one row gather, renders them through the
  whole chain and all its kernels, and keeps its own rows. The gather
  stands in for the JAX path's ``ppermute`` hops: rows beyond the frame are
  reflected once about the frame edge (reflect-101, the convention of
  every conv in the chain) and then clipped, as the JAX path's gather does.
  Grain and burn see frame coordinates (``render_chain``'s
  ``grain_row_offset`` and ``burn_ref_hw``), so interior seams match the
  unsharded render.

Not ported: the ``space_mode="spmd"`` path (XLA's SPMD partitioner with the
XLA conv forms, ROADMAP.md "Not to port"); it raises ValueError.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch

from raw2film_tpu_torch.pipeline.render import RenderConfig, bundle_to, render_chain


@dataclass(frozen=True)
class Mesh:
    """A (batch, space) grid of devices. ``shape`` reads as JAX's:
    ``{"batch": b, "space": s}``."""

    devices: tuple  # batch rows of space columns of torch.device

    @property
    def shape(self) -> dict:
        return {"batch": len(self.devices), "space": len(self.devices[0])}


def make_mesh(
    n_devices: int | None = None, batch: int | None = None, space: int | None = None,
    devices: list | None = None,
) -> Mesh:
    """Build a (batch, space) mesh over ``devices`` (default: every CUDA
    device), all on the batch axis unless told otherwise. ``devices`` may
    repeat a device: a virtual mesh on one card, or ``["cpu"] * n`` for the
    plain versions."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices) or n == 0:
        raise ValueError(
            f"make_mesh: {n} devices requested but only {len(devices)} available; for a "
            f"virtual mesh on one device pass devices=[device] * {max(n, 1)}"
        )
    devices = devices[:n]
    if batch is None and space is None:
        batch, space = n, 1
    elif batch is None:
        batch = n // space
    elif space is None:
        space = n // batch
    if batch * space != n:
        raise ValueError(f"make_mesh: batch*space ({batch}*{space}) must equal n devices ({n})")
    return Mesh(tuple(tuple(devices[r * space : (r + 1) * space]) for r in range(batch)))


def _on(device):
    """The context that makes ``device`` current (the kernels launch on the
    current device's stream)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def batch_render_fn(cfg: RenderConfig):
    """Batched render: (B, 3, H, W) float32 XYZ and B uint32 grain seeds ->
    (B, 3, H, W) uint8, one ``render_chain`` after another (the counterpart
    of the JAX package's ``lax.map``)."""

    def fn(xyz_batch, bundle, seeds, grain_row_offset=0, burn_ref_hw=None):
        return torch.stack([
            render_chain(x, bundle, cfg, int(s), grain_row_offset, burn_ref_hw)
            for x, s in zip(xyz_batch, seeds)
        ])

    return fn


def space_halo_rows(cfg: RenderConfig, h: int, w: int) -> int:
    """Overlap margin (rows) for the halo space path: the SUMMED spatial
    support of the cascaded stages (a seam row's MTF inputs are halation
    outputs whose own inputs reach further into the pad — max() of the
    supports under-halos). Halation's exact kernel radius is
    scale/4 * halation_size px (reference: effects.py:200-217); the MTF
    kernel is ~0.1 mm wide plus the unsharp sigma; highlight burn's
    down-up blur spans ~6 * ceil(min(h,w)/burn_scale) full-res px."""
    halo = 8.0
    if cfg.halation:
        halo += cfg.scale / 4.0 * cfg.halation_size
    if cfg.sharpness and cfg.has_mtf:
        halo += 0.08 * cfg.scale + 4.0 * max(cfg.sharpening_sigma, 0.0)
    if cfg.chroma_nr:
        halo += 2.0 * cfg.chroma_nr + 1
    if cfg.highlight_burn:
        # Blur support in low-res cells (sigma=3 trunc=2 -> radius ~7) plus
        # one bilinear cell, plus one cell of slack for the global-grid
        # alignment slice (ops/burn.py::_aligned_slice drops a partial cell
        # at the strip bottom).
        f = math.ceil(min(h, w) / cfg.burn_scale)
        halo += 9.0 * f
    return int(-(-halo // 8) * 8)


def halo_rows(h: int, lo: int, hi: int, device) -> torch.Tensor:
    """Frame rows of padded rows lo..hi-1 of a frame of h rows: rows beyond
    the frame reflected once about its edge (reflect-101), then clipped to
    it (where the pad exceeds the frame). Built on ``device``."""
    r = torch.arange(lo, hi, device=device)
    r = torch.where(r < 0, -r, r)
    r = torch.where(r > h - 1, 2 * (h - 1) - r, r)
    return torch.clamp(r, 0, h - 1)


def sharded_batch_render(mesh: Mesh, cfg: RenderConfig, space_mode: str = "halo"):
    """The batched render over ``mesh``: fn(xyz (B, 3, H, W) float32, bundle,
    seeds) -> (B, 3, H, W) uint8 on the input's device. Image b renders on
    batch row b % batch; with a space axis its rows are split over that
    row's devices (the halo path, see the module docstring). The bundle is
    replicated to each device once and cached for as long as the caller
    passes the same bundle."""
    if space_mode != "halo":
        raise ValueError(
            f"space_mode {space_mode!r} is not ported: the SPMD path exists only because XLA "
            "cannot split a Pallas call (ROADMAP.md, 'Not to port'); use space_mode='halo'"
        )
    batch, space = mesh.shape["batch"], mesh.shape["space"]
    replicas: dict = {}

    def on_device(bundle, device):
        key = str(device)
        hit = replicas.get(key)
        if hit is None or hit[0] is not bundle:
            hit = replicas[key] = (bundle, bundle_to(bundle, device))
        return hit[1]

    def fn(xyz, bundle, seeds):
        b, _, h, w = xyz.shape
        if h % space:
            raise ValueError(f"sharded_batch_render: H={h} is not a multiple of space={space}")
        seeds = [int(s) for s in np.asarray(seeds).reshape(-1)]
        if len(seeds) != b:
            raise ValueError(f"sharded_batch_render: {len(seeds)} seeds for {b} images")
        out = torch.empty((b, 3, h, w), dtype=torch.uint8, device=xyz.device)
        h_loc = h // space
        halo = space_halo_rows(cfg, h, w) if space > 1 else 0
        for i in range(b):
            for s, dev in enumerate(mesh.devices[i % batch]):
                with _on(dev):
                    if space == 1:
                        res = render_chain(xyz[i].to(dev), on_device(bundle, dev), cfg, seeds[i])
                    else:
                        lo = s * h_loc - halo
                        rows = halo_rows(h, lo, lo + h_loc + 2 * halo, xyz.device)
                        slab = xyz[i].index_select(1, rows).to(dev)
                        res = render_chain(
                            slab, on_device(bundle, dev), cfg, seeds[i], lo, (h, w)
                        )[:, halo : halo + h_loc]
                out[i, :, s * h_loc : (s + 1) * h_loc].copy_(res)
        return out

    return fn
