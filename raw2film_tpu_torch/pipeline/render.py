"""The render chain: CFA mosaic or camera XYZ -> uint8 film print.

The counterpart of ``raw2film_tpu/pipeline/render.py``. Stage order:

    demosaic + input transform (K1; the staged path decodes with
    ``io/raw.py``, runs chroma NR (its blur on K2) and applies the input
    matrix in plain torch)
    -> [halation: /4 box downsample (K10) -> small blur (K2)
        -> x4 row upsample (K12) -> ranks + lerp + combine (K14);
        or, for other frame sizes and pyramid levels, the full-res ranks
        (K2) plus per level K10 -> K2 -> K13 or the bilinear resize]
    -> development (in K14's epilogue with identity masking, else plain torch)
    -> MTF sharpness + colour grain (K2), or MTF (K2) then grain without it:
       colour (K8), black-and-white (K9), or any other mode the field
       alone (K7) and the add in plain torch
    -> [burn: small map, its blur on K2] -> print/encode (K3)
    -> [ICC output LUT: K3 encodes to float, then the CP-factored LUT
        (``ops/lut.py``), the clip to [0, 1] and the rounding to uint8]

K2 launches on frames the TPU's K2 declines stand for K4 (``ops/sep_rank.py``).
The plain development and the CP LUT apply are PyTorch, as they are XLA on
the TPU. No stage is ever skipped silently.

Planar (3, H, W) float32 at every public function; the film parameters are
a dict of float32 tensors and a host copy of the input matrix
(:func:`make_film_bundle`), the static choices a
:class:`RenderConfig`. The grain seed is a uint32 integer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from raw2film_tpu_torch.config import LOG10_EPS
from raw2film_tpu_torch.device import require_cuda
from raw2film_tpu_torch.ops import burn as burn_ops
from raw2film_tpu_torch.ops.chroma_nr import chroma_nr
from raw2film_tpu_torch.ops import demosaic as dm
from raw2film_tpu_torch.ops import fastmath as fm
from raw2film_tpu_torch.ops import grain as grain_ops
from raw2film_tpu_torch.ops import halation as hal_ops
from raw2film_tpu_torch.ops.lut import apply_lut_3d_cp
from raw2film_tpu_torch.ops import mtf as mtf_ops
from raw2film_tpu_torch.ops import print_encode as pe


@dataclass(frozen=True)
class RenderConfig:
    """Static configuration of one render (the JAX package's RenderConfig
    without its TPU-only tiling fields)."""

    scale: float  # pixels per mm on film
    halation: bool = True
    halation_size: float = 1.0
    bw: bool = False
    sharpness: bool = True
    has_mtf: bool = True
    sharpening_strength: float = 0.0
    sharpening_sigma: float = 1.0
    grain: int = 2
    has_grain: bool = True
    grain_size_mm: float = 0.006
    grain_sigma: float = 0.4
    highlight_burn: bool = False
    burn_scale: float = 50.0
    chroma_nr: int = 0
    print_mode: str = "print"  # "print" | "inversion" | "direct"
    shadow_comp: bool = False
    sat_neutral: bool = True
    gamma_func: str = "sRGB"
    mtf_key: tuple | None = None
    mtf_signed: bool = False
    icc: bool = False
    mask_identity: bool = True
    quantize: bool = True


def make_film_bundle(
    neg_p,
    prt_p,
    out_p,
    halation_intensity: float = 1.0,
    halation_green_factor: float = 0.3,
    highlight_burn: float = 0.0,
    d_ref_green: float = 1.0,
    grain_rms: float = 0.0,
    grain_shape: tuple = (1.0, 1.2, 0.15, 0.0, 4.0),
    sat: float = 1.0,
    device=None,
) -> dict:
    """Pack the calibrated chain (film/chain.py parameter records) into a
    dict of float32 tensors with the JAX bundle's keys and shapes, plus
    ``m_in_host`` (:func:`host_m_in`) and ``pvec_host``
    (:func:`host_print_vec`)."""

    def dev(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    print_parts = {
        "a": prt_p.a, "log_e0": prt_p.log_e0, "prt_curve": prt_p.curve, "d_offset": prt_p.d_offset,
        "v": prt_p.v, "shadow_comp": prt_p.shadow_comp, "shadow_ref": prt_p.shadow_ref,
        "vd_offset": prt_p.vd_offset, "to_display": out_p.to_display, "white_gain": out_p.white_gain,
        "sat": sat, "highlight_burn": highlight_burn,
    }
    return {
        "m_in": dev(neg_p.m_in),
        "m_in_host": host_m_in(neg_p.m_in),
        "pvec_host": host_print_vec(print_parts),
        "flare": dev(neg_p.flare),
        "neg_curve": tuple(dev(c) for c in neg_p.curve),
        "mask": dev(neg_p.mask),
        "d_min": dev(neg_p.d_min.reshape(3, 1, 1)),
        "a": dev(prt_p.a),
        "log_e0": dev(prt_p.log_e0.reshape(3, 1, 1)),
        "prt_curve": tuple(dev(c) for c in prt_p.curve),
        "v": dev(prt_p.v),
        "d_offset": dev(prt_p.d_offset.reshape(3, 1, 1)),
        "vd_offset": dev(prt_p.vd_offset.reshape(3, 1, 1)),
        "shadow_comp": dev(prt_p.shadow_comp),
        "shadow_ref": dev(prt_p.shadow_ref),
        "to_display": dev(out_p.to_display),
        "white_gain": dev(out_p.white_gain.reshape(3, 1, 1)),
        "sat": dev(sat),
        "hal_intensity": dev(halation_intensity),
        "hal_green": dev(halation_green_factor),
        "highlight_burn": dev(highlight_burn),
        "d_ref_green": dev(d_ref_green),
        "grain_rms": dev(grain_rms),
        "grain_shape": dev(np.asarray(grain_shape, np.float32)),
    }


def host_m_in(m_in) -> np.ndarray:
    """The bundle's ``m_in_host``: a read-only float32 numpy copy of the
    input matrix, made from the host array the bundle's ``m_in`` is made
    from. The fused path folds the camera matrix into it on the host, so a
    render reads no matrix back from the device."""
    host = np.array(m_in, np.float32)
    host.setflags(write=False)
    return host


def host_print_vec(parts: dict) -> np.ndarray:
    """The bundle's ``pvec_host``: a read-only float32 numpy copy of K3's 61
    film parameters (``ops/print_encode.py::pack_print_vec``), packed from
    the host arrays the bundle's entries are made from. The render hands it
    to K3, so it reads no parameters back from the device."""
    host = {
        k: tuple(np.array(c, np.float32) for c in parts[k]) if isinstance(parts[k], tuple)
        else np.array(parts[k], np.float32)
        for k in pe.PVEC_KEYS
    }
    vec = pe.pack_print_vec(host).numpy().copy()
    vec.setflags(write=False)
    return vec


def bundle_to(bundle: dict, device) -> dict:
    """The bundle with every tensor on ``device`` (host copies stay)."""

    def to(v):
        if isinstance(v, tuple):
            return tuple(t.to(device) for t in v)
        return v.to(device) if isinstance(v, torch.Tensor) else v

    return {k: to(v) for k, v in bundle.items()}


def build_render_config(neg, prt, prt_mode: str, scale: float, merged: dict) -> RenderConfig:
    """Derive the static config from merged params (pipeline.params of the
    JAX package)."""
    return RenderConfig(
        scale=float(scale),
        halation=bool(merged["halation"]),
        halation_size=float(merged["halation_size"]),
        bw=neg.is_bw,
        sharpness=bool(merged["sharpness"]),
        has_mtf=neg.mtf is not None,
        sharpening_strength=float(merged["sharpening_strength"]),
        sharpening_sigma=float(merged["sharpening_sigma"]),
        grain=int(merged["grain"]),
        has_grain=neg.rms_density is not None,
        grain_size_mm=float(merged["grain_size"]) / 1000.0,
        grain_sigma=float(merged["grain_sigma"]),
        highlight_burn=bool(merged["highlight_burn"])
        and (prt is not None or neg.density_measure in ("status_m", "bw")),
        burn_scale=float(merged["burn_scale"]),
        chroma_nr=int(merged["chroma_nr"]),
        print_mode=prt_mode,
        shadow_comp=bool(merged["shadow_comp"]),
        sat_neutral=float(merged["sat_adjust"]) == 1.0,
        gamma_func=str(merged["gamma_func"]),
        mtf_key=mtf_ops._hashable_mtf(neg.mtf) if neg.mtf is not None else None,
        mtf_signed=bool(merged.get("mtf_fidelity", False)),
        mask_identity=neg.is_bw or float(merged["color_masking"]) == 1.0,
    )


def load_film_bundle(
    negative: str = "Kodak Portra 400",
    print_film: str = "Fuji Crystal Archive Maxima",
    h: int = 5472,
    w: int = 8208,
    device=None,
    **params,
) -> tuple[dict, RenderConfig]:
    """(bundle, cfg) for a negative printed on a print stock, at h x w
    pixels on a 36 mm frame; ``params`` override the merged profile and
    image parameters (e.g. ``halation=False, grain=2, highlight_burn=0.3``).
    The bundle lies on ``device``, by default the first CUDA device; pass
    ``device="cpu"`` for the plain versions."""
    from raw2film_tpu_torch.film import chain, loader
    from raw2film_tpu_torch.pipeline import params as rparams

    device = torch.device(device) if device is not None else require_cuda()
    stocks = loader.load_film_stocks()
    neg, prt = stocks[negative], stocks[print_film]
    neg_p = chain.build_negative_params(neg)
    prt_p = chain.build_print_params(neg, prt, neg_params=neg_p)
    out_p = chain.build_output_params(neg, prt, prt_p, neg_p)
    merged = rparams.merge_params(rparams.ProfileParams(), rparams.ImageParams())
    merged.update(params)
    gm = neg.grain
    d_min, *_ = neg.curve.params()
    bundle = make_film_bundle(
        neg_p,
        prt_p,
        out_p,
        halation_intensity=float(merged["halation_intensity"]),
        halation_green_factor=float(merged["halation_green_factor"]),
        highlight_burn=float(merged["highlight_burn"]),
        d_ref_green=float(neg.d_ref[1]),
        grain_rms=gm.rms,
        grain_shape=(
            gm.peak_density, gm.width, gm.floor,
            float(np.min(d_min)), float(np.max(neg.curve.d_max)),
        ),
        device=device,
    )
    cfg = build_render_config(neg, prt, prt_p.mode, max(h, w) / 36.0, merged)
    return bundle, cfg


# ---------------------------------------------------------------- chain


def _matp(m: torch.Tensor, planes):
    """3x3 mix of three planes as scalar mul-adds (exact float32)."""
    return tuple(m[i, 0] * planes[0] + m[i, 1] * planes[1] + m[i, 2] * planes[2] for i in range(3))


def _hd_plane(x: torch.Tensor, curve, c: int) -> torch.Tensor:
    d_min, gamma, x_toe, x_sh, w_t, w_s = (t.reshape(3, -1)[c, 0] for t in curve)
    return d_min + gamma * (fm.softplus(x - x_toe, w_t) - fm.softplus(x - x_sh, w_s))


def _develop(ep: torch.Tensor, bundle: dict) -> torch.Tensor:
    """(3, H, W) exposure -> status densities with masking (plain torch)."""
    xp = tuple(fm.log10(torch.clamp(ep[c] + bundle["flare"], min=LOG10_EPS)) for c in range(3))
    dm_ = bundle["d_min"].reshape(3, -1)
    dp = tuple(_hd_plane(xp[c], bundle["neg_curve"], c) - dm_[c, 0] for c in range(3))
    dp = tuple(q + dm_[c, 0] for c, q in enumerate(_matp(bundle["mask"], dp)))
    return torch.stack(dp)


def render_chain(
    xyz: torch.Tensor,
    bundle: dict,
    cfg: RenderConfig,
    seed: int,
    grain_row_offset: int = 0,
    burn_ref_hw: tuple | None = None,
    input_is_exposure: bool = False,
) -> torch.Tensor:
    """(3, H, W) float32 camera XYZ (or, with ``input_is_exposure``, the
    chain's exposure image) -> (3, H, W) uint8 encoded output. With
    ``cfg.icc`` the bundle carries the ICC output LUT's CP factors
    (``icc_u``, ``icc_v``, ``icc_w``), applied before the rounding.

    A row shard of a larger frame (``parallel/mesh.py``) passes the frame
    row of its row 0 as ``grain_row_offset``, so its grain hash rows are the
    frame's, and the frame's (H, W) as ``burn_ref_hw``, so the burn takes
    the frame's factor and aligns its cells to the frame's grid at that
    same row offset."""
    if input_is_exposure:
        ep = xyz.contiguous()  # a cropped exposure image is a strided view
    else:
        if cfg.chroma_nr:
            xyz = chroma_nr(xyz, cfg.chroma_nr)
        ep = torch.stack(
            [torch.clamp(q, min=0.0) for q in _matp(bundle["m_in"], (xyz[0], xyz[1], xyz[2]))]
        )

    d = None
    if cfg.halation:
        factors = hal_ops.colour_factors(bundle, cfg.bw)
        # With identity masking (the default) K14 also develops to density,
        # so the exposure image never returns to memory.
        devvec = hal_ops.develop_vector(bundle) if cfg.mask_identity else None
        combined = hal_ops.halation_combined_fused(
            ep, cfg.scale, cfg.halation_size, factors, develop=devvec
        )
        if combined is None:  # below the mixture tier: glow, then the combine
            blur = hal_ops.halation_blur(ep, cfg.scale, cfg.halation_size)
            f = factors.reshape(3, 1, 1)
            ep = (ep + f * blur) / (1.0 + f)
        elif devvec is not None:
            d = combined  # developed in K14
        else:
            ep = combined

    if d is None:
        d = _develop(ep, bundle)

    mtf_on = cfg.sharpness and cfg.has_mtf and cfg.mtf_key is not None
    grain_on = bool(cfg.grain and cfg.has_grain)
    if grain_on:
        prm = grain_ops.grain_params(bundle["grain_rms"], bundle["grain_shape"], cfg.scale)
        sigma_px = grain_ops.correlation_sigma_px(cfg.scale, cfg.grain_size_mm, cfg.grain_sigma)
        gseed = grain_ops.seed2(seed, grain_row_offset)
    if mtf_on and grain_on and cfg.grain == 2:
        d = mtf_ops.film_sharpness_grain(
            d, cfg.mtf_key, cfg.scale, cfg.sharpening_strength, cfg.sharpening_sigma,
            gseed, sigma_px, prm, signed=cfg.mtf_signed,
        )
        mtf_on = grain_on = False
    if mtf_on:
        d = mtf_ops.film_sharpness(
            d, cfg.mtf_key, cfg.scale, cfg.sharpening_strength, cfg.sharpening_sigma,
            signed=cfg.mtf_signed,
        )
    if grain_on and cfg.grain in (1, 2):
        d = grain_ops.grain_apply(d.contiguous(), gseed, sigma_px, prm, bw=cfg.grain == 1)
    elif grain_on:
        # Any other mode: the colour field alone (K7), then the amplitude and
        # the add in plain torch (render.py:354-377 of the JAX package, whose
        # black-and-white field and channel-mean amplitude there serve grain
        # 1 only off the TPU; here grain 1 always takes K9).
        field = grain_ops.grain_field(gseed, tuple(d.shape[-2:]), sigma_px, device=d.device)
        d = torch.clamp(d + grain_ops.grain_amplitude(d, prm) * field, min=0.0)

    burn_args = None
    if cfg.highlight_burn:
        burn_row = grain_row_offset if burn_ref_hw is not None else None
        burn_args = burn_ops.burn_smallmap(
            d, bundle["d_ref_green"], cfg.burn_scale, ref_hw=burn_ref_hw, row_offset=burn_row
        )
        if burn_args is None:
            d = burn_ops.burn(
                d, bundle["d_ref_green"], bundle["highlight_burn"], cfg.burn_scale,
                ref_hw=burn_ref_hw, row_offset=burn_row,
            )
    out = pe.print_encode(
        d.contiguous(), bundle["pvec_host"], cfg.print_mode, cfg.shadow_comp,
        cfg.sat_neutral, cfg.gamma_func, quantize=cfg.quantize and not cfg.icc, burn=burn_args,
    )
    if not cfg.icc:
        return out
    # The ICC display/softproof transform, baked into a CP-factored LUT and
    # applied to the encoded float image before the 8-bit rounding.
    rgb = torch.clamp(
        apply_lut_3d_cp(out, bundle["icc_u"], bundle["icc_v"], bundle["icc_w"], scale=1.0), 0.0, 1.0
    )
    if not cfg.quantize:
        return rgb
    return torch.round(rgb * 255.0).to(torch.uint8)


def _print_tail(d: torch.Tensor, bundle: dict, cfg: RenderConfig) -> torch.Tensor:
    """The plain tail without burn (the counterpart of the JAX package's
    ``_print_tail``): K3's plain version on the bundle's parameters."""
    return pe.print_encode_plain(
        d, pe.pack_print_vec(bundle), cfg.print_mode, cfg.shadow_comp,
        cfg.sat_neutral, cfg.gamma_func, quantize=cfg.quantize,
    )


def fold_input_matrix(m_in, cam_to_xyz, exposure_gain=1.0) -> np.ndarray:
    """m_in @ (gain * cam_to_xyz) in float32 on the host."""

    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, np.float32)

    return np.matmul(host(m_in), host(cam_to_xyz) * host(exposure_gain))


def render_chain_from_mosaic(
    mosaic,
    cam_to_xyz,
    bundle: dict,
    cfg: RenderConfig,
    seed: int,
    pattern: str = "RGGB",
    exposure_gain=1.0,
    crop: tuple | None = None,
    norm=None,
    device=None,
) -> torch.Tensor:
    """CFA mosaic -> rendered uint8 (3, H, W): the fused demosaic (K1, with
    the camera matrix and exposure gain folded into the chain's input
    transform, m_in' = m_in @ (gain * cam_to_xyz)) and then the chain.

    ``mosaic``: (H, W) uint16 sensor codes with ``norm`` = (black,
    inv_range), normalized on the device, or float32 in [0, 1]. ``crop``:
    (y0, x0, h, w) window taken after the demosaic. ``device``: where to
    render; by default the first CUDA device (raises without one), never
    the CPU unless asked with ``device="cpu"``."""
    if cfg.chroma_nr != 0:
        raise ValueError(
            "render_chain_from_mosaic does not support chroma_nr; decode "
            "to XYZ and use render_chain (the staged path) instead"
        )
    device = torch.device(device) if device is not None else require_cuda()
    mosaic = torch.as_tensor(mosaic, device=device).contiguous()
    b = bundle_to(bundle, device)
    mat = fold_input_matrix(b["m_in_host"], cam_to_xyz, exposure_gain)
    ep = dm.demosaic_exposure(mosaic, pattern, mat, norm=norm)
    if crop is not None:
        y0, x0, ch, cw = crop
        ep = ep[:, y0 : y0 + ch, x0 : x0 + cw]
    return render_chain(ep, b, cfg, seed, input_is_exposure=True)
