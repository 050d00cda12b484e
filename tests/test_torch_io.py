"""The port's host edges against the JAX package: the staged RAW decode
(``io/raw.py``: Bayer MHC on K1, bilinear on K2, half-size on K11, X-Trans, non-CFA data,
orientation, the exposure estimate), the JAX-free lens module, and the
resampling of ``ops/resize.py`` against ``jax.image.resize``."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import raw2film_tpu  # noqa: F401
from raw2film_tpu.data import XYZ_TO_REC709
from raw2film_tpu.io import lens as jlens
from raw2film_tpu.io import raw as jraw
from raw2film_tpu.io.dng import RawImage, write_dng
from raw2film_tpu.io.raf import XTRANS_CANONICAL
from raw2film_tpu.ops.resize import resolution_scaling as jax_scaling
from raw2film_tpu_torch.io import lens as tlens
from raw2film_tpu_torch.io import raw as traw
from raw2film_tpu_torch.ops import resize as tresize

# float32 decodes that differ in summation order only (the MHC convs, the
# 3x3 camera matrix): a few ulp of unit-range values.
DECODE_TOL = 5e-6


def _raw(kind: str, orientation: int = 1) -> RawImage:
    rng = np.random.default_rng(21)
    meta = {"EXIF:ISO": 200, "EXIF:ExposureTime": 1 / 60, "EXIF:FNumber": 5.6}
    if orientation != 1:
        meta["EXIF:Orientation"] = orientation
    cm = np.asarray(XYZ_TO_REC709)
    if kind == "linear":
        data = rng.uniform(300, 15000, (30, 44, 3)).astype(np.float32)
        return RawImage(data, None, 256.0, 16000.0, cm, None, meta)
    shape = (42, 66) if kind == "xtrans" else (41, 67)
    data = rng.integers(200, 16000, shape).astype(np.uint16)
    pattern = XTRANS_CANONICAL if kind == "xtrans" else kind
    return RawImage(data, pattern, 256.0, 16000.0, cm, None, meta)


DECODES = [("GRBG", False, 1), ("BGGR", True, 1), ("RGGB", False, 6), ("GBRG", True, 3),
           ("xtrans", False, 1), ("xtrans", True, 8), ("linear", False, 5)]


@pytest.mark.parametrize("kind,half,orient", DECODES, ids=[f"{k}-{'half' if h else 'full'}-o{o}" for k, h, o in DECODES])
def test_decode_raw_matches_jax(kind, half, orient):
    raw = _raw(kind, orient)
    ref = np.asarray(jraw.decode_raw(raw, half_size=half))
    got = traw.decode_raw(raw, half_size=half).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= (1e-5 if kind == "xtrans" else DECODE_TOL)


@pytest.mark.parametrize("pattern,orient", [("RGGB", 1), ("GBRG", 6)])
def test_decode_raw_bilinear_matches_jax(pattern, orient):
    """``decode_raw(demosaic="bilinear")``: the full-size Bayer decode on
    the bilinear stencils (on K2), within 1e-5 of the JAX decode."""
    raw = _raw(pattern, orient)
    ref = np.asarray(jraw.decode_raw(raw, demosaic="bilinear"))
    got = traw.decode_raw(raw, demosaic="bilinear").numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-5
    assert np.abs(got - traw.decode_raw(raw).numpy()).max() > 1e-3  # not the MHC decode


@pytest.mark.parametrize("orientation", range(1, 9))
def test_apply_orientation_matches_jax(orientation):
    x = np.arange(3 * 4 * 5, dtype=np.float32).reshape(3, 4, 5)
    ref = np.asarray(jraw.apply_orientation(jnp.asarray(x), orientation))
    np.testing.assert_array_equal(traw.apply_orientation(torch.from_numpy(x), orientation).numpy(), ref)


@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
def test_raw_to_linear_matches_jax(tmp_path, half):
    rng = np.random.default_rng(22)
    path = str(tmp_path / "d.dng")
    write_dng(path, rng.uniform(0.05, 0.6, (48, 72)) * 60000, white_level=60000, iso=400)
    ref, ref_meta = jraw.raw_to_linear(path, half_size=half, cache=False)
    got, meta = traw.raw_to_linear(path, half_size=half)
    assert meta == ref_meta
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


METADATA = [
    None,
    {},
    {"EXIF:ISO": 100, "EXIF:ExposureTime": 1 / 125, "EXIF:FNumber": 4.0},
    {"EXIF:ISO": 3200, "EXIF:ExposureTime": 0.5},
    {"EXIF:ISO": "bad", "EXIF:ExposureTime": 1 / 30},
    {"EXIF:ISO": 100, "EXIF:ExposureTime": 0},
]


@pytest.mark.parametrize("subsampled", [False, True])
@pytest.mark.parametrize("meta", range(len(METADATA)))
def test_calc_exposure_matches_jax(meta, subsampled):
    x = np.random.default_rng(23).uniform(0.0, 0.8, (3, 20, 30)).astype(np.float32)
    arg = x[1, ::2, ::2] if subsampled else x
    kw = dict(metadata=METADATA[meta], subsampled=subsampled)
    assert traw.calc_exposure(arg, **kw) == jraw.calc_exposure(arg, **kw)


# ------------------------------------------------------------ lens

LENS_METADATA = [
    {"EXIF:LensModel": "FE 24-70mm F2.8 GM", "EXIF:FocalLength": 24.0, "EXIF:FNumber": 2.8},
    {"EXIF:LensModel": "EF24-105mm f/4L IS USM", "EXIF:FocalLength": 50.0, "EXIF:FNumber": 5.6},
    {"EXIF:LensModel": "XF18-55mmF2.8-4 R LM OIS", "EXIF:FocalLength": 18.0, "EXIF:FNumber": 2.8},
    {"EXIF:LensModel": "85mm F1.4 DG DN | Art 020", "EXIF:FocalLength": 85.0, "EXIF:FNumber": 1.4},
    {"EXIF:LensModel": "35mm F1.4"},
    {"EXIF:Make": "Canon", "EXIF:FocalLength": "50", "EXIF:FNumber": 1.8},
    {"EXIF:Make": "raw2film-tpu", "EXIF:FocalLength": 50.0, "EXIF:FNumber": 2.0},
    {"EXIF:Make": "SomeCam", "EXIF:LensModel": "Unknown 12-345mm"},
]


def test_lens_profiles_match_jax():
    jp = [dataclasses.asdict(p) for p in jlens.load_profiles(path="/nonexistent")]
    tp = [dataclasses.asdict(p) for p in tlens.load_profiles(path="/nonexistent")]
    assert tp == jp and len(tp) > 500


@pytest.mark.parametrize("meta", range(len(LENS_METADATA)))
def test_find_profile_and_correction_match_jax(meta):
    md = LENS_METADATA[meta]
    jp, tp = jlens.find_profile(md), tlens.find_profile(md)
    assert (jp is None) == (tp is None)
    if jp is None:
        return
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    img = np.random.default_rng(24).uniform(0.1, 0.9, (3, 40, 62)).astype(np.float32)
    ref = jlens.lens_correction(img, md)
    got = tlens.lens_correction(img, md)
    assert got.dtype == np.float32 and np.abs(got - ref).max() <= 1e-6


@pytest.mark.parametrize("hw,ks", [((37, 53), (-1.05, 0.3, -0.08)), ((60, 90), (-0.3, 0.05, 0.0)), ((8, 8), (-40.0, 0.0, 0.0))])
def test_vignetting_gain_matches_jax(hw, ks):
    np.testing.assert_array_equal(tlens.vignetting_gain(hw, ks), np.asarray(jlens.vignetting_gain(hw, ks)))


# ------------------------------------------------------------ resize

# (input shape, resolution): integer shrink (the box mean), fractional
# shrink (antialiased linear), enlarge (Lanczos-5), a ragged integer shrink
# (falls to the linear resize), and no change.
SCALINGS = {
    "box": ((3, 40, 60), (20, 30)),
    "linear": ((3, 40, 60), (27, 40)),
    "lanczos": ((3, 30, 45), (100, 100)),
    "ragged": ((3, 41, 60), (20, 30)),
    "same": ((3, 40, 60), (40, 60)),
}


@pytest.mark.parametrize("case", list(SCALINGS))
def test_resolution_scaling_matches_jax(case):
    shape, res = SCALINGS[case]
    x = np.random.default_rng(25).uniform(0.0, 1.0, shape).astype(np.float32)
    ref = np.asarray(jax_scaling(jnp.asarray(x), res))
    got = tresize.resolution_scaling(torch.from_numpy(x), res).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 3e-6


def test_bilinear_resize_matches_jax():
    """The halation glow's fallback upsample: scale 194 / 48 on H (edge
    weights renormalized), exactly 4 on W."""
    import jax

    x = np.random.default_rng(26).uniform(0.0, 1.0, (3, 48, 160)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (3, 194, 640), "bilinear"))
    got = tresize.resize(torch.from_numpy(x), (194, 640), "linear").numpy()
    assert np.abs(got - ref).max() <= 3e-6
