"""Processor: the port's ``process()`` of a RAW file or an XYZ image.

The counterpart of ``raw2film_tpu/pipeline/processor.py``, with the same
parameter names and defaults, so settings and profile JSONs carry over. It
takes one of two paths, as the JAX Processor does:

- the fused path (full resolution, no geometry, lens profile or resize):
  the uint16 mosaic goes to the device and ``render_chain_from_mosaic``
  demosaics (K1) with the camera matrix and exposure folded into the
  chain's input transform;
- the staged path (the half-size default, and any geometry, lens
  correction or ``max_scale`` cap): ``io/raw.py`` decodes on the device
  (K11 or K1), the image makes a round trip through the host for the lens
  remap and the geometry, and ``render_chain`` renders it.

The device is explicit: ``Processor(device=...)``; with none given it
requires CUDA and never falls back to the CPU. The grain key is JAX's
``fold_in(PRNGKey(seed), i)``, rebuilt on the host (:func:`fold_in`), so a
render's grain matches the JAX Processor's. The decode caches are keyed on
the file's path, ``mtime_ns`` and size.

An ICC transform (``icc_transform``) is baked into a CP-factored output
LUT on the host (``io/icc.py::bake_output_cp``) and uploaded once per
transform object; the render applies it before the 8-bit rounding.

``process_batch(mesh=...)`` renders on a device mesh
(``parallel/mesh.py``): every image staged, grouped by shape, sharded over
the mesh's batch and space axes.

Not ported here: the TPU's scoped-VMEM retry ladder and the JIT cache (the
port compiles nothing per shape).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from raw2film_tpu_torch.device import disable_tf32, require_cuda
from raw2film_tpu_torch.film import chain as fchain
from raw2film_tpu_torch.film import loader
from raw2film_tpu_torch.film import stock as stock_mod
from raw2film_tpu_torch.io import dng
from raw2film_tpu_torch.io import lens as lens_mod
from raw2film_tpu_torch.io.raw import calc_exposure, raw_to_linear
from raw2film_tpu_torch.ops.resize import resolution_scaling
from raw2film_tpu_torch.pipeline import canvas, geometry
from raw2film_tpu_torch.pipeline.render import (
    build_render_config,
    make_film_bundle,
    render_chain,
    render_chain_from_mosaic,
)

MAX_SCALE_DEFAULT = 400.0  # px/mm preview cap

# ------------------------------------------------------------ grain key

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key: tuple[int, int], x0: int, x1: int) -> tuple[int, int]:
    """Threefry-2x32, 20 rounds, on one counter pair (uint32 values held in
    Python ints), as ``jax.random``'s threefry2x32."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` (32-bit types): (0, seed mod 2^32)."""
    return 0, int(seed) & _M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``."""
    return _threefry2x32(key, 0, int(data) & _M32)


def grain_seed(key: tuple[int, int]) -> int:
    """The render's uint32 grain seed: key[0] ^ key[1]."""
    return key[0] ^ key[1]


# ------------------------------------------------------------ crop windows


def _resolve_stock(stock):
    if stock is None or isinstance(stock, stock_mod.FilmStock):
        return stock
    return loader.load_film_stocks()[str(stock)]


def _aspect_crop_window(h: int, w: int, aspect: float) -> tuple[slice, slice]:
    """The (rows, cols) window geometry.crop_to_aspect keeps on a (C, h, w)
    image (a copy of the JAX Processor's, pinned to it by the tests)."""
    x, y = h, w
    if x > y:
        if x > aspect * y:
            lo = math.ceil(x / 2 - y * aspect / 2)
            hi = math.ceil(x / 2 + y * aspect / 2)
            return slice(lo, hi), slice(0, y)
        lo = math.ceil(y / 2 - x / aspect / 2)
        hi = math.ceil(y / 2 + x / aspect / 2)
        return slice(0, x), slice(lo, hi)
    if y > aspect * x:
        lo = math.ceil(y / 2 - x * aspect / 2)
        hi = math.ceil(y / 2 + x * aspect / 2)
        return slice(0, x), slice(lo, hi)
    lo = math.ceil(x / 2 - y / aspect / 2)
    hi = math.ceil(x / 2 + y / aspect / 2)
    return slice(lo, hi), slice(0, y)


def _staged_crop_window(h: int, w: int, aspect: float) -> tuple[slice, slice]:
    """The composed window of crop_rotate_zoom's two crop_to_aspect calls
    (the ceil-centre crop is not idempotent)."""
    r1, c1 = _aspect_crop_window(h, w, aspect)
    r2, c2 = _aspect_crop_window(r1.stop - r1.start, c1.stop - c1.start, aspect)
    return (
        slice(r1.start + r2.start, r1.start + r2.stop),
        slice(c1.start + c2.start, c1.start + c2.stop),
    )


def _mosaic_aspect_crop(mosaic: np.ndarray, aspect: float):
    """An even-aligned superset of the staged crop window (Bayer phase kept,
    4 px of demosaic context) and the inner (y0, x0, h, w) window to take
    after the demosaic (None when the superset is the window)."""
    h, w = mosaic.shape
    rows, cols = _staged_crop_window(h, w, aspect)
    ext = 4
    y_lo = max(rows.start - ext, 0)
    y_lo -= y_lo % 2
    x_lo = max(cols.start - ext, 0)
    x_lo -= x_lo % 2
    y_hi = min(rows.stop + ext, h)
    x_hi = min(cols.stop + ext, w)
    sup = mosaic[y_lo:y_hi, x_lo:x_hi]
    dy, dx = rows.start - y_lo, cols.start - x_lo
    ch, cw = rows.stop - rows.start, cols.stop - cols.start
    if (dy, dx) == (0, 0) and sup.shape == (ch, cw):
        return np.ascontiguousarray(sup), None
    return np.ascontiguousarray(sup), (dy, dx, ch, cw)


def _half_size_xyz(mosaic: np.ndarray, pattern: str, cam_to_xyz: np.ndarray,
                   black: float = 0.0, inv_range: float = 1.0) -> np.ndarray:
    """Host half-size decode -> (3, H/2, W/2) XYZ, the fused path's sample
    for the exposure estimate."""
    h2, w2 = mosaic.shape[0] // 2, mosaic.shape[1] // 2
    m = mosaic[: h2 * 2, : w2 * 2]

    def cell(y, x):
        p = m[y::2, x::2].astype(np.float32)
        return np.clip((p - black) * inv_range, 0.0, 1.0)

    c00, c01, c10, c11 = cell(0, 0), cell(0, 1), cell(1, 0), cell(1, 1)
    cells = {pattern[0]: c00, pattern[1]: c01, pattern[2]: c10, pattern[3]: c11}
    greens = [c01 if pattern[1] == "G" else None, c10 if pattern[2] == "G" else None]
    g = (
        np.mean([x for x in greens if x is not None], axis=0)
        if any(x is not None for x in greens)
        else cells.get("G", c00)
    )
    rgb = np.stack([cells.get("R", g), g, cells.get("B", g)])
    return np.einsum("ij,jhw->ihw", cam_to_xyz, rgb).astype(np.float32)


def _file_key(src):
    """(path, mtime_ns, size) of a file source; None for anything else (an
    array or a parsed RawImage is never cached)."""
    if isinstance(src, (np.ndarray, dng.RawImage)):
        return None
    path = os.path.abspath(str(src))
    st = os.stat(path)
    return path, st.st_mtime_ns, st.st_size


_BUNDLE_KEYS = (
    "exp_kelvin", "tint", "exp_comp", "push_pull", "color_masking", "red_light",
    "green_light", "blue_light", "projector_kelvin", "shadow_comp", "sat_adjust",
    "inversion_gamma", "idealized_curve", "white_balance", "white_clip", "gamma_func",
    "halation_intensity", "halation_green_factor", "highlight_burn",
)
_LOAD_KEYS = (
    "frame_width", "frame_height", "rotation", "zoom", "rotate_times", "flip",
    "resolution", "half_size", "chroma_nr", "max_scale", "lens_correction", "cam", "lens",
)
_MERGED_DEFAULTS = dict(
    exp_kelvin=6500.0, tint=0.0, exp_comp=0.0, push_pull=0.0, color_masking=1.0,
    red_light=0.0, green_light=0.0, blue_light=0.0, projector_kelvin=6500.0,
    shadow_comp=0.0, sat_adjust=1.0, inversion_gamma=4.0, idealized_curve=False,
    inversion=False, white_balance=False, white_clip=False, gamma_func="sRGB",
    halation_intensity=1.0, halation_green_factor=0.4, highlight_burn=0.0,
    halation=True, halation_size=1.0, sharpness=True, sharpening_strength=0.0,
    sharpening_sigma=1.0, grain=2, grain_size=6.0, grain_sigma=0.4, burn_scale=50.0,
    chroma_nr=0, mtf_fidelity=False,
)


class Processor:
    """Image and film-bundle caches plus ``process()`` on one device."""

    def __init__(self, cameras=None, lenses=None, device=None):
        self.device = torch.device(device) if device is not None else require_cuda()
        if self.device.type == "cuda":
            disable_tf32(verbose=False)
        self.cameras = cameras or {}
        self.lenses = lenses or {}
        self._decode_key = self._decode = None
        self._image_cache_key = self._image_cache = None
        self._mosaic_cache_key = self._mosaic_cache = None
        self._bundle_key = self._bundle = None
        self._icc_cache: dict = {}
        self.last_metadata: dict = {}

    def register_lens(self, name: str) -> bool:
        """Resolve a lens model name from the profile database into
        ``lenses`` so ``process(lens=name)`` uses it; returns whether the
        name now resolves."""
        if not name or name in self.lenses:
            return bool(name) and name in self.lenses
        for p in lens_mod.load_profiles():
            if p.model == name:
                self.lenses[name] = p
                return True
        return False

    # ------------------------------------------------------------ image

    def _decoded(self, src, half_size: bool, cache: bool):
        """raw_to_linear, with a one-slot cache keyed on the file."""
        fkey = _file_key(src) if cache else None
        key = (fkey, half_size)
        if fkey is not None and key == self._decode_key:
            return self._decode
        arg = src if isinstance(src, dng.RawImage) else str(src)
        result = raw_to_linear(arg, half_size=half_size, device=self.device)
        if fkey is not None:
            self._decode_key, self._decode = key, result
        return result

    def load_image(self, src, frame_width=36.0, frame_height=24.0, rotation=0.0, zoom=1.0,
                   rotate_times=0, flip=False, resolution=None, half_size=True, cache=True,
                   chroma_nr=0, max_scale=None, lens_correction=False, cam=None, lens=None):
        """Decode and geometry: returns ((3, H, W) XYZ on the device,
        orig_resolution, metadata). The decoded image makes a round trip
        through the host for the lens remap and the geometry."""
        del chroma_nr  # noise reduction belongs to the render chain
        fkey = _file_key(src)
        cache = cache and fkey is not None
        key = (
            fkey, frame_width, frame_height, rotation, zoom, rotate_times, flip,
            tuple(resolution) if resolution is not None else None, half_size, max_scale,
            lens_correction, str(lens),
        )
        if cache and key == self._image_cache_key:
            return self._image_cache

        if isinstance(src, np.ndarray):
            xyz = np.asarray(src, np.float32)
            if xyz.ndim == 3 and xyz.shape[-1] == 3 and xyz.shape[0] != 3:
                xyz = xyz.transpose(2, 0, 1)  # HWC input
            metadata = {}
        else:
            dev_xyz, metadata = self._decoded(src, half_size, cache)
            xyz = dev_xyz.cpu().numpy()

        if lens_correction and metadata:
            profile = self.lenses.get(lens) if lens else None
            xyz = lens_mod.lens_correction(xyz, metadata, profile)
        xyz = geometry.crop_rotate_zoom(xyz, frame_width, frame_height, rotation, zoom,
                                        rotate_times, flip)
        if resolution is None and max_scale is not None:
            resolution = xyz.shape[-2:]
        orig_resolution = tuple(resolution) if resolution is not None else None
        out = torch.as_tensor(np.ascontiguousarray(xyz, np.float32), device=self.device)
        if resolution is not None:
            scale = max(resolution) / max(frame_width, frame_height)
            if max_scale is not None and scale > max_scale:
                f = max_scale / scale
                resolution = [round(v * f) for v in resolution]
            out = resolution_scaling(out, tuple(resolution)).contiguous()

        result = (out, orig_resolution, metadata)
        if cache:
            self._image_cache_key, self._image_cache = key, result
        return result

    # ------------------------------------------------------------ bundles

    def load_film_bundle(self, negative_film, print_film, merged: dict):
        """(bundle on the device, print mode), cached on the parameters that
        shape it."""
        key = {
            "negative_film": negative_film.name,
            "print_film": print_film.name if print_film is not None else None,
            **{k: merged[k] for k in _BUNDLE_KEYS},
            "inversion": merged.get("inversion", False),
        }
        if key == self._bundle_key:
            return self._bundle
        neg_p = fchain.build_negative_params(
            negative_film, exp_kelvin=merged["exp_kelvin"], tint=merged["tint"],
            exp_comp=merged["exp_comp"], push_pull=merged["push_pull"],
            color_masking=merged["color_masking"],
        )
        inversion = bool(merged.get("inversion", False)) or (
            print_film is None and negative_film.film_type == "negative"
        )
        prt_p = fchain.build_print_params(
            negative_film, print_film, red_light=merged["red_light"],
            green_light=merged["green_light"], blue_light=merged["blue_light"],
            projector_kelvin=merged["projector_kelvin"], shadow_comp=merged["shadow_comp"],
            inversion_gamma=merged["inversion_gamma"], idealized_curve=merged["idealized_curve"],
            inversion=inversion, white_balance=merged["white_balance"], neg_params=neg_p,
        )
        out_p = fchain.build_output_params(
            negative_film, print_film, prt_p, neg_p, projector_kelvin=merged["projector_kelvin"],
            sat_adjust=merged["sat_adjust"], gamma_func=merged["gamma_func"],
            white_clip=merged["white_clip"],
        )
        d_ref = negative_film.d_ref
        gm = negative_film.grain
        d_min, *_ = negative_film.curve.params()
        lo, hi = float(np.min(d_min)), float(np.max(negative_film.curve.d_max))
        if hi < lo:
            lo, hi = hi, lo
        bundle = make_film_bundle(
            neg_p, prt_p, out_p,
            halation_intensity=merged["halation_intensity"],
            halation_green_factor=merged["halation_green_factor"],
            highlight_burn=merged["highlight_burn"],
            d_ref_green=float(d_ref[1] if len(d_ref) > 1 else d_ref[0]),
            grain_rms=(gm.rms if gm else 0.0),
            grain_shape=(gm.peak_density, gm.width, gm.floor, lo, hi) if gm else (1.0, 1.2, 0.15, 0.0, 4.0),
            sat=merged["sat_adjust"],
            device=self.device,
        )
        self._bundle_key, self._bundle = key, (bundle, prt_p.mode)
        return self._bundle

    # ------------------------------------------------------------ process

    def process(
        self, src, negative_film, grain_size: float = 6.0, grain_sigma: float = 0.4,
        lens_correction: bool = True, print_film=None, exp_comp: float = 0.0,
        red_light: float = 0.0, green_light: float = 0.0, blue_light: float = 0.0,
        projector_kelvin: float = 6500.0, shadow_comp: float = 0.0, sat_adjust: float = 1.0,
        gamma_func: str = "sRGB", exp_kelvin: float = 6500.0, tint: float = 0.0,
        inversion_gamma: float = 4.0, idealized_curve: bool = False, inversion: bool = False,
        push_pull: float = 0.0, white_balance: bool = False, white_clip: bool = False,
        icc_transform=None, resolution=None, frame_width: float = 36.0,
        frame_height: float = 24.0, rotation: float = 0.0, zoom: float = 1.0,
        rotate_times: int = 0, flip: bool = False, cam=None, lens=None,
        canvas_mode: str = "No", canvas_scale: float = 1.0, canvas_ratio: float = 1.0,
        halation_intensity: float = 1.0, halation: bool = True, halation_size: float = 1.0,
        halation_green_factor: float = 0.4, sharpness: bool = True,
        sharpening_strength: float = 0.0, sharpening_sigma: float = 1.0, chroma_nr: int = 0,
        grain: int = 2, highlight_burn: float = 0.0, burn_scale: float = 50.0,
        half_size: bool = True, cache: bool = True, color_masking: float | None = None,
        mtf_fidelity: bool = False, max_scale: float | None = MAX_SCALE_DEFAULT,
        seed: int = 0, fused_decode: bool = True, **_,
    ) -> np.ndarray:
        """Load and render one image; returns uint8 (H, W, 3). A full-res
        source without geometry, lens profile or resize takes the fused
        path unless ``fused_decode=False``; everything else is staged."""
        load_kw = dict(
            frame_width=frame_width, frame_height=frame_height, rotation=rotation, zoom=zoom,
            rotate_times=rotate_times, flip=flip, resolution=resolution, half_size=half_size,
            chroma_nr=chroma_nr, max_scale=max_scale, lens_correction=lens_correction,
            cam=cam, lens=lens,
        )
        merged = dict(
            exp_kelvin=exp_kelvin, tint=tint, exp_comp=exp_comp, push_pull=push_pull,
            color_masking=color_masking if color_masking is not None else 1.0,
            red_light=red_light, green_light=green_light, blue_light=blue_light,
            projector_kelvin=projector_kelvin, shadow_comp=shadow_comp, sat_adjust=sat_adjust,
            inversion_gamma=inversion_gamma, idealized_curve=idealized_curve,
            inversion=inversion, white_balance=white_balance, white_clip=white_clip,
            gamma_func=gamma_func, halation_intensity=halation_intensity,
            halation_green_factor=halation_green_factor, highlight_burn=highlight_burn,
            halation=halation, halation_size=halation_size, sharpness=sharpness,
            sharpening_strength=sharpening_strength, sharpening_sigma=sharpening_sigma,
            grain=grain, grain_size=grain_size, grain_sigma=grain_sigma, burn_scale=burn_scale,
            chroma_nr=chroma_nr, mtf_fidelity=mtf_fidelity,
        )
        finish_kw = dict(canvas_mode=canvas_mode, canvas_scale=canvas_scale, canvas_ratio=canvas_ratio)
        key = fold_in(prng_key(seed), 0)
        return self._render(
            src, _resolve_stock(negative_film), _resolve_stock(print_film), load_kw, merged,
            key, cache, fused_decode, self._icc_arrays(icc_transform), finish_kw,
        )

    def _icc_arrays(self, icc_transform):
        """CP-factored (u, v, w) device tensors for an ICC transform, cached
        per transform object (None for no transform)."""
        if icc_transform is None:
            return None
        from raw2film_tpu_torch.io.icc import bake_output_cp

        key = id(icc_transform)
        cached = self._icc_cache.get(key)
        if cached is None or cached[0] is not icc_transform:
            u, v, w_bc, err = bake_output_cp(icc_transform)
            arrays = tuple(torch.as_tensor(a, device=self.device) for a in (u, v, w_bc))
            cached = (icc_transform, arrays, err)
            self._icc_cache[key] = cached
        return cached[1]

    @staticmethod
    def _attach_icc(bundle: dict, cfg, icc):
        """The bundle carrying the CP factors ``icc`` (from :meth:`_icc_arrays`)
        and cfg.icc set, so the render applies them before the rounding."""
        if icc is None:
            return bundle, cfg
        bundle = dict(bundle)
        bundle["icc_u"], bundle["icc_v"], bundle["icc_w"] = icc
        return bundle, dataclasses.replace(cfg, icc=True)

    def _render(self, src, negative_film, print_film, load_kw, merged, key, cache, fused,
                icc, finish_kw) -> np.ndarray:
        """One image through the fused or the staged path, then _finish."""
        fast = parsed = None
        if fused:
            fast, parsed = self._try_load_mosaic(src, load_kw, cache=cache)
        if fast is None:
            xyz, orig_resolution, meta = self.load_image(
                parsed if parsed is not None else src, cache=cache, **load_kw
            )
            self.last_metadata = dict(meta or {})
            out_hw = tuple(xyz.shape[-2:])
        else:
            orig_resolution = None
            self.last_metadata = dict(parsed.metadata or {})
            mosaic, norm, pattern, cam_m, gain, crop = fast
            out_hw = (crop[2], crop[3]) if crop is not None else mosaic.shape
        bundle, prt_mode = self.load_film_bundle(negative_film, print_film, merged)
        scale = max(out_hw) / max(load_kw["frame_width"], load_kw["frame_height"])
        cfg = build_render_config(negative_film, print_film, prt_mode, scale, merged)
        bundle, cfg = self._attach_icc(bundle, cfg, icc)
        seed = grain_seed(key)
        if fast is None:
            out = render_chain(xyz, bundle, cfg, seed)
        else:
            out = render_chain_from_mosaic(
                mosaic, cam_m, bundle, cfg, seed, pattern, gain, crop, norm, device=self.device
            )
        return self._finish(out.cpu().numpy(), orig_resolution=orig_resolution, **finish_kw)

    def _finish(self, out_chw: np.ndarray, canvas_mode="No", canvas_scale=1.0,
                canvas_ratio=1.0, orig_resolution=None) -> np.ndarray:
        """(3, H, W) uint8 -> (H, W, 3): the canvas, then the resize back to
        ``orig_resolution`` (clipped and truncated to uint8, as in the JAX
        Processor)."""
        image = out_chw.transpose(1, 2, 0)
        image = canvas.add_canvas(image, canvas_mode, canvas_scale, canvas_ratio)
        if orig_resolution is not None and tuple(image.shape[:2]) != tuple(orig_resolution):
            chw = torch.as_tensor(
                np.ascontiguousarray(image.transpose(2, 0, 1)), dtype=torch.float32, device=self.device
            )
            scaled = resolution_scaling(chw, tuple(orig_resolution)).cpu().numpy()
            image = np.clip(scaled, 0, 255).astype(np.uint8).transpose(1, 2, 0)
        return image

    # ---------------------------------------------------------- fused path

    def _try_load_mosaic(self, src, load_kw: dict, cache: bool = False):
        """One-slot caching wrapper over :meth:`_try_load_mosaic_impl`, keyed
        on the file (path, mtime_ns, size) and the load parameters."""
        fkey = _file_key(src) if cache else None
        if fkey is None:
            return self._try_load_mosaic_impl(src, load_kw)
        key = (fkey, repr(sorted(load_kw.items(), key=lambda kv: kv[0])))
        if key == self._mosaic_cache_key:
            return self._mosaic_cache
        result = self._try_load_mosaic_impl(src, load_kw)
        self._mosaic_cache_key, self._mosaic_cache = key, result
        return result

    def _try_load_mosaic_impl(self, src, load_kw: dict):
        """Fused-path eligibility and host preparation: ((mosaic, norm,
        pattern, cam_to_xyz, exposure gain, crop) | None, the parsed
        RawImage | None). An ineligible parsed file is handed back so the
        staged path does not parse it again."""
        if isinstance(src, np.ndarray):
            return None, None
        if load_kw.get("half_size", True):
            return None, None
        for k in ("rotation", "rotate_times", "flip", "chroma_nr"):
            if load_kw.get(k):
                return None, None
        if float(load_kw.get("zoom", 1.0)) != 1.0:
            return None, None
        if load_kw.get("resolution") is not None or load_kw.get("max_scale") is not None:
            return None, None
        if load_kw.get("cam") is not None:
            return None, None
        raw = src if isinstance(src, dng.RawImage) else dng.read_raw(str(src))
        if raw.cfa_pattern is None or len(raw.cfa_pattern) != 4:
            return None, raw
        if int(raw.metadata.get("EXIF:Orientation", 1) or 1) != 1:
            return None, raw
        if load_kw.get("lens_correction"):
            # Eligible only when lens correction is a no-op (no profile).
            lens_name = load_kw.get("lens")
            prof = self.lenses.get(lens_name) if lens_name else lens_mod.find_profile(raw.metadata)
            if prof is not None:
                return None, raw
        inv_range = 1.0 / max(raw.white_level - raw.black_level, 1.0)
        norm = np.asarray([raw.black_level, inv_range], np.float32)
        mosaic_u16 = np.ascontiguousarray(raw.data)
        if mosaic_u16.dtype != np.uint16:
            # Integral sensor codes held as float (RAF, RW2) upload as u16.
            as_u16 = mosaic_u16.astype(np.uint16)
            if (
                mosaic_u16.min() >= 0.0
                and mosaic_u16.max() <= 65535.0
                and np.array_equal(as_u16.astype(mosaic_u16.dtype), mosaic_u16)
            ):
                mosaic_u16 = as_u16
        cam = (
            np.linalg.inv(np.asarray(raw.color_matrix, np.float64))
            if raw.color_matrix is not None
            else np.eye(3)
        ).astype(np.float32)
        # The staged path estimates exposure on the whole decoded frame,
        # before the aspect crop; so does this.
        gain = np.float32(2.0 ** calc_exposure(
            _half_size_xyz(raw.data, raw.cfa_pattern, cam, black=float(raw.black_level),
                           inv_range=float(inv_range)),
            metadata=raw.metadata,
        ))
        fw = float(load_kw.get("frame_width", 36.0))
        fh = float(load_kw.get("frame_height", 24.0))
        mosaic, crop = _mosaic_aspect_crop(mosaic_u16, fw / fh)
        return (mosaic, norm, raw.cfa_pattern, cam, gain, crop), raw

    # ---------------------------------------------------------- batch

    def process_batch(self, srcs: list, negative_film, mesh=None, seed: int = 0,
                      **params) -> list[np.ndarray]:
        """Render many images. Image i takes the grain key
        fold_in(PRNGKey(seed), i), as in the JAX Processor, so image 0
        equals ``process(srcs[0], seed=seed)``. An ICC transform is baked
        and attached once for the batch.

        Without a mesh the images render one at a time on this Processor's
        device. With a mesh (``parallel/mesh.py::make_mesh``) every image
        takes the staged path (decoded on this device, then held on the
        host); images of one shape are stacked in groups of at least
        ``mesh.shape["batch"]`` (a short group padded by repeating its
        images, the padding dropped after the render) and rendered by
        ``sharded_batch_render``; finishing stays per image."""
        negative_film = _resolve_stock(negative_film)
        print_film = _resolve_stock(params.pop("print_film", None))
        load_kw = {k: params[k] for k in _LOAD_KEYS if k in params}
        load_kw.setdefault("frame_width", 36.0)
        load_kw.setdefault("frame_height", 24.0)
        load_kw.setdefault("half_size", True)
        load_kw.setdefault("lens_correction", True)
        load_kw.setdefault("max_scale", MAX_SCALE_DEFAULT)
        merged = dict(_MERGED_DEFAULTS)
        merged.update({k: v for k, v in params.items() if k in merged})
        finish_kw = {k: params.get(k, d) for k, d in
                     (("canvas_mode", "No"), ("canvas_scale", 1.0), ("canvas_ratio", 1.0))}
        base = prng_key(seed)
        icc = self._icc_arrays(params.get("icc_transform"))
        if mesh is None:
            return [
                self._render(
                    src, negative_film, print_film, load_kw, merged, fold_in(base, idx), False,
                    bool(params.get("fused_decode", True)), icc, finish_kw,
                )
                for idx, src in enumerate(srcs)
            ]
        return self._render_on_mesh(
            mesh, srcs, negative_film, print_film, load_kw, merged, base, icc, finish_kw
        )

    def _render_on_mesh(self, mesh, srcs, negative_film, print_film, load_kw, merged, base,
                        icc, finish_kw) -> list[np.ndarray]:
        """process_batch over a mesh: decode and bucket by shape, render each
        group with ``sharded_batch_render``, finish per image."""
        from raw2film_tpu_torch.parallel.mesh import sharded_batch_render

        buckets: dict = {}
        for idx, src in enumerate(srcs):
            xyz, orig_resolution, meta = self.load_image(src, cache=False, **load_kw)
            self.last_metadata = dict(meta or {})
            # held on the host, as the JAX Processor holds its decoded
            # arrays, so a long roll does not fill the card
            buckets.setdefault(tuple(xyz.shape), []).append((idx, xyz.cpu(), orig_resolution))
        bundle, prt_mode = self.load_film_bundle(negative_film, print_film, merged)
        fw, fh = load_kw["frame_width"], load_kw["frame_height"]
        per = mesh.shape["batch"]
        results: list = [None] * len(srcs)
        for shape, items in buckets.items():
            scale = max(shape[-2:]) / max(fw, fh)
            cfg = build_render_config(negative_film, print_film, prt_mode, scale, merged)
            bundle_c, cfg = self._attach_icc(bundle, cfg, icc)
            render = sharded_batch_render(mesh, cfg)
            # groups of at most ~2 GB of float32 input, and at least one
            # image per batch row
            group = max(int(2e9 // (int(np.prod(shape)) * 4)), 1, per)
            for g0 in range(0, len(items), group):
                part = items[g0 : g0 + group]
                n = len(part)
                tiled = [part[k % n] for k in range(n + (-n) % per)]
                batch = torch.stack([x for _, x, _ in tiled]).to(self.device)
                seeds = [grain_seed(fold_in(base, idx)) for idx, _, _ in tiled]
                out = render(batch, bundle_c, seeds)[:n].cpu().numpy()
                for (idx, _, orig_resolution), img in zip(part, out):
                    results[idx] = self._finish(img, orig_resolution=orig_resolution, **finish_kw)
        return results
