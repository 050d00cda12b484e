"""The whole ported slice on the CPU against the JAX render_chain_from_mosaic
on the CPU: same uint16 mosaic, same normalization, same grain seed, held to
1 uint8 code. With halation on, the port is held to the JAX chain in its
TPU form (Pallas kernels in interpret mode), since the JAX CPU form takes
another halation formulation; so are the mixture tier's other branches (a
frame whose H is not a multiple of 4, the /8 pyramid level). Also the
branches the port once refused, which must render and never skip a stage."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import raw2film_tpu  # noqa: F401
from __graft_entry__ import _build
from raw2film_tpu.data import REC709_TO_XYZ
from raw2film_tpu.pipeline.render import render_chain_from_mosaic as jax_render
from raw2film_tpu_torch import render_chain, render_chain_from_mosaic
from raw2film_tpu_torch.convert import bundle_from_numpy, config_from_jax
from raw2film_tpu_torch.ops import halation as thal

NORM = np.array([512.0, 1.0 / 15000.0], np.float32)


def _codes(h, w, seed=3):
    rng = np.random.default_rng(seed)
    row = np.abs(rng.normal(0.35, 0.2, (1, w)))
    col = np.abs(rng.normal(1.0, 0.3, (h, 1)))
    tex = rng.uniform(0.6, 1.4, (h, w))
    return np.clip(512 + 15000 * row * col * tex, 0, 65535).astype(np.uint16)


def _numpy_bundle(jb):
    return {k: tuple(np.asarray(a) for a in v) if isinstance(v, tuple) else np.asarray(v) for k, v in jb.items()}


# (frame the config is built for, mosaic rendered):
# - 448 x 672 itself: 3-tap MTF, white grain, burn factor 9 (the small map
#   and the print kernel's burn prologue);
# - the 45 MP config on a 256 x 384 mosaic: 23-tap MTF ranks, 3-tap grain,
#   burn factor 6 (the staged burn).
CASES = {"448x672": ((448, 672), (448, 672)), "45MP-cfg": ((5472, 8208), (256, 384))}


@pytest.mark.parametrize("case", list(CASES))
def test_render_matches_jax(case):
    (bh, bw), (h, w) = CASES[case]
    jb, jcfg = _build(bh, bw, halation=False)
    codes = _codes(h, w)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(
        jax_render(
            jnp.asarray(codes), jnp.asarray(REC709_TO_XYZ, jnp.float32), jb, jcfg, key,
            "RGGB", 1.0, None, jnp.asarray(NORM),
        )
    )
    seed = int(np.asarray(key[0] ^ key[1]))
    got = render_chain_from_mosaic(
        codes, REC709_TO_XYZ, bundle_from_numpy(_numpy_bundle(jb)), config_from_jax(jcfg), seed, norm=NORM,
        device="cpu",
    )
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, h, w)
    diff = np.abs(got.numpy().astype(int) - ref.astype(int))
    equal = float((diff == 0).mean())
    print(f"{case}: max {diff.max()} code, {equal:.6f} of codes equal")
    assert diff.max() <= 1
    assert equal >= 0.999


def test_crop_and_gain_match_jax():
    jb, jcfg = _build(5472, 8208, halation=False)
    codes = _codes(128, 160, seed=5)
    key = jax.random.PRNGKey(11)
    crop = (3, 5, 96, 120)
    ref = np.asarray(
        jax_render(
            jnp.asarray(codes), jnp.asarray(REC709_TO_XYZ, jnp.float32), jb, jcfg, key,
            "GBRG", 1.7, crop, jnp.asarray(NORM),
        )
    )
    got = render_chain_from_mosaic(
        codes, REC709_TO_XYZ, bundle_from_numpy(_numpy_bundle(jb)), config_from_jax(jcfg),
        int(np.asarray(key[0] ^ key[1])), pattern="GBRG", exposure_gain=1.7, crop=crop, norm=NORM,
        device="cpu",
    )
    assert tuple(got.shape) == (3, 96, 120)
    assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1


# (config overrides, mosaic shape). Each once raised naming an unported
# kernel or module: "halation" the mixture tier (228 px/mm, size 57) on a
# frame whose H is not a multiple of 4 (K13), then grain without the MTF
# (K8), black-and-white grain (K9) and the ICC output LUT (ops/lut.py).
UNPORTED = {
    "halation": (dict(halation=True, scale=228.0), (34, 48)),
    "grain-without-mtf": (dict(sharpness=False), (32, 48)),
    "bw-grain": (dict(grain=1), (32, 48)),
    "icc": (dict(icc=True), (32, 48)),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_branches_raise(name, monkeypatch):
    """Each renders: the halation case through halation_blur's resize tier
    (no stage skipped), the grain cases and the ICC output LUT (a float
    transform baked into CP factors, applied after K3's float encode and
    before the rounding) within 1 code of the JAX CPU form, whose grain is
    the same hash field."""
    jb, jcfg = _build(256, 384, halation=False)
    overrides, hw = UNPORTED[name]
    if name == "icc":
        from raw2film_tpu.io.icc import bake_output_cp

        jb = dict(jb)
        jb["icc_u"], jb["icc_v"], jb["icc_w"], _ = bake_output_cp(lambda x: np.clip(x, 0, 1) ** 1.35)
    cfg = dataclasses.replace(config_from_jax(jcfg), **overrides)
    args = (_codes(*hw), REC709_TO_XYZ, bundle_from_numpy(_numpy_bundle(jb)), cfg, 0)
    if name == "halation":
        blurs = []
        orig = thal.halation_blur
        monkeypatch.setattr(thal, "halation_blur", lambda *a: blurs.append(a[1:]) or orig(*a))
        got = render_chain_from_mosaic(*args, norm=NORM, device="cpu")
        assert blurs == [(228.0, cfg.halation_size)]
        assert got.dtype == torch.uint8 and tuple(got.shape) == (3, *hw)
        return
    jcfg = dataclasses.replace(jcfg, **overrides)
    worst, equal = _render_both(jb, jcfg, _codes(*hw), key=0)
    print(f"{name}: max {worst} code, {equal:.6f} of codes equal")
    assert worst <= 1


def test_fused_path_folds_the_host_m_in(monkeypatch):
    """The fused path folds the camera matrix and gain into the bundle's
    host copy of m_in (m_in_host, equal to the device copy), so it reads
    nothing back from the device: with the device m_in poisoned (NaN) it
    renders the same codes, and K1 gets the fold of the host copy, equal
    bit for bit to the fold of the device copy."""
    from raw2film_tpu_torch import load_film_bundle
    from raw2film_tpu_torch.ops import demosaic as tdm
    from raw2film_tpu_torch.pipeline.render import fold_input_matrix

    bundle, cfg = load_film_bundle(h=32, w=48, device="cpu", halation=False, grain=2, sharpness=True)
    np.testing.assert_array_equal(bundle["m_in_host"], bundle["m_in"].numpy())
    mats = []
    orig = tdm.demosaic_exposure
    monkeypatch.setattr(tdm, "demosaic_exposure", lambda x, p, mat, norm=None: mats.append(mat) or orig(x, p, mat, norm))
    codes = _codes(32, 48, seed=9)
    want = render_chain_from_mosaic(codes, REC709_TO_XYZ, bundle, cfg, 5, exposure_gain=1.3, norm=NORM, device="cpu")
    poisoned = dict(bundle, m_in=torch.full((3, 3), float("nan")))
    got = render_chain_from_mosaic(codes, REC709_TO_XYZ, poisoned, cfg, 5, exposure_gain=1.3, norm=NORM, device="cpu")
    assert torch.equal(got, want)
    folded = fold_input_matrix(bundle["m_in"], REC709_TO_XYZ, 1.3)
    assert len(mats) == 2 and np.isfinite(folded).all()
    for mat in mats:
        np.testing.assert_array_equal(mat, folded)


def test_render_hands_k3_the_host_print_vec(monkeypatch):
    """The render hands K3 the bundle's host copy of the print vector
    (pvec_host, equal to the packed device entries), so K3's wrapper reads
    nothing back from the device: with the device print entries poisoned
    (NaN) it renders the same codes."""
    from raw2film_tpu_torch import load_film_bundle
    from raw2film_tpu_torch.ops import print_encode as tpe

    bundle, cfg = load_film_bundle(h=32, w=48, device="cpu", halation=False, grain=2, sharpness=True,
                                   highlight_burn=0.3)
    np.testing.assert_array_equal(bundle["pvec_host"], tpe.pack_print_vec(bundle).numpy())
    seen = []
    orig = tpe.print_encode
    monkeypatch.setattr(tpe, "print_encode", lambda d, pvec, *a, **k: seen.append(pvec) or orig(d, pvec, *a, **k))
    codes = _codes(32, 48, seed=11)
    want = render_chain_from_mosaic(codes, REC709_TO_XYZ, bundle, cfg, 5, norm=NORM, device="cpu")
    nan = float("nan")
    poisoned = dict(bundle, a=torch.full((3, 3), nan), v=torch.full((3, 3), nan),
                    to_display=torch.full((3, 3), nan), prt_curve=tuple(torch.full_like(c, nan) for c in bundle["prt_curve"]))
    got = render_chain_from_mosaic(codes, REC709_TO_XYZ, poisoned, cfg, 5, norm=NORM, device="cpu")
    assert torch.equal(got, want)
    assert len(seen) == 2 and all(p is bundle["pvec_host"] for p in seen)


def test_chroma_nr_is_refused():
    """The mosaic path refuses chroma NR, as the JAX one does; the staged
    render_chain runs it (ops/chroma_nr.py), within 1 code of JAX."""
    from raw2film_tpu.pipeline.render import render_chain as jax_chain

    jb, jcfg = _build(256, 384, halation=False)
    cfg = dataclasses.replace(config_from_jax(jcfg), chroma_nr=2)
    bundle = bundle_from_numpy(_numpy_bundle(jb))
    with pytest.raises(ValueError):
        render_chain_from_mosaic(_codes(32, 48), REC709_TO_XYZ, bundle, cfg, 0, norm=NORM, device="cpu")
    xyz = np.abs(np.random.default_rng(12).normal(0.2, 0.15, (3, 32, 48))).astype(np.float32)
    key = jax.random.PRNGKey(2)
    ref = np.asarray(jax_chain(jnp.asarray(xyz), jb, dataclasses.replace(jcfg, chroma_nr=2), key))
    got = render_chain(torch.from_numpy(xyz), bundle, cfg, int(np.asarray(key[0] ^ key[1])))
    assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1


def test_staged_render_chain_matches_jax():
    """render_chain from camera XYZ (the input transform in plain torch)."""
    from raw2film_tpu.pipeline.render import render_chain as jax_chain

    jb, jcfg = _build(5472, 8208, halation=False)
    xyz = np.abs(np.random.default_rng(2).normal(0.2, 0.15, (3, 96, 128))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_chain(jnp.asarray(xyz), jb, jcfg, key))
    got = render_chain(
        torch.from_numpy(xyz), bundle_from_numpy(_numpy_bundle(jb)), config_from_jax(jcfg),
        int(np.asarray(key[0] ^ key[1])),
    )
    assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1


@pytest.fixture
def tpu_form(monkeypatch):
    """The JAX chain in its TPU form on the CPU: ``_use_pallas`` is True, so
    every stage takes its Pallas kernel, and every pallas_call runs in
    interpret mode. Records which halation_mega calls returned an image.
    The XLA caches are cleared around the test, so no trace of the CPU form
    is reused and none of this form outlives the test."""
    from jax.experimental import pallas as pl

    from raw2film_tpu.ops import conv as jconv
    from raw2film_tpu.ops import pallas_halation

    orig_call, orig_mega = pl.pallas_call, pallas_halation.halation_mega
    served = []

    def interpret_call(*args, **kwargs):
        return orig_call(*args, **dict(kwargs, interpret=True))

    def mega(*args, **kwargs):
        out = orig_mega(*args, **kwargs)
        served.append(out is not None)
        return out

    jax.clear_caches()
    monkeypatch.setattr(jconv, "_use_pallas", lambda: True)
    monkeypatch.setattr(pl, "pallas_call", interpret_call)
    monkeypatch.setattr(pallas_halation, "halation_mega", mega)
    yield served
    jax.clear_caches()


def _render_both(jb, jcfg, codes, key=7):
    key = jax.random.PRNGKey(key)
    ref = np.asarray(
        jax_render(
            jnp.asarray(codes), jnp.asarray(REC709_TO_XYZ, jnp.float32), jb, jcfg, key,
            "RGGB", 1.0, None, jnp.asarray(NORM),
        )
    )
    got = render_chain_from_mosaic(
        codes, REC709_TO_XYZ, bundle_from_numpy(_numpy_bundle(jb)), config_from_jax(jcfg),
        int(np.asarray(key[0] ^ key[1])), norm=NORM, device="cpu",
    )
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    diff = np.abs(got.numpy().astype(int) - ref.astype(int))
    return int(diff.max()), float((diff == 0).mean())


@pytest.mark.parametrize("taps", ["fp32", "dc"])
def test_halation_render_matches_jax_tpu_form(taps, tpu_form, monkeypatch):
    """The benchmark config with halation on (228 px/mm: the mixture tier,
    K10 -> K2 -> K12 -> K14 with the development in K14) on a 192 x 640
    mosaic, against the JAX TPU form, where halation_mega serves the stage.

    The TPU form's MTF rescales its taps so their bf16 rounding keeps the
    DC gain ("dc" precision); the port runs the taps in float32 and does not
    carry that rescale (ROADMAP.md, "Not to port"). "fp32" gives the JAX MTF
    float32 taps too, and the port then agrees on >= 99.9 % of codes
    (measured 99.998 %). "dc" keeps the TPU form as it is: within 1 code,
    with 83.4 % of codes equal (measured), all from the MTF's rescale."""
    if taps == "fp32":
        from raw2film_tpu.ops import pallas_conv2

        orig = pallas_conv2.fused_sep_rank_mxu
        monkeypatch.setattr(
            pallas_conv2, "fused_sep_rank_mxu", lambda *a, **k: orig(*a, **dict(k, precision=None))
        )
    jb, jcfg = _build(5472, 8208)
    assert jcfg.halation and jcfg.mask_identity
    worst, equal = _render_both(jb, jcfg, _codes(192, 640, seed=9))
    print(f"halation on, {taps} MTF taps: max {worst} code, {equal:.6f} of codes equal")
    assert tpu_form == [True]
    assert worst <= 1
    if taps == "fp32":
        assert equal >= 0.999


def test_halation_render_without_develop_matches_jax_cpu_form(monkeypatch):
    """mask_identity=False: K14 returns the combined exposure and the plain
    development follows. Held to the default JAX CPU form, whose halation is
    the XLA Gaussian mixture (halation.py:178-184), not the ranks-plus-
    pyramid form of the TPU and the port: within 1 code (measured 99.47 % of
    codes equal on this input)."""
    calls = []
    orig = thal.halation_mega
    monkeypatch.setattr(thal, "halation_mega", lambda *a, **k: calls.append(a[5:]) or orig(*a, **k))
    jb, jcfg = _build(5472, 8208)
    jcfg = dataclasses.replace(jcfg, mask_identity=False)
    worst, equal = _render_both(jb, jcfg, _codes(128, 192, seed=4))
    print(f"halation on, no develop in K14: max {worst} code, {equal:.6f} of codes equal")
    assert calls == [(None,)]
    assert worst <= 1


# (config overrides, mosaic): the mixture tier where halation_combined_fused
# returns None and halation_blur serves the TPU. "resize": H = 194 is not a
# multiple of 4, so the /4 level goes back by the bilinear resize (scale
# 194 / 48); "pyramid-8": halation size 3.0 (size 171) adds the /8 level,
# both levels upsampled by K13 (bilinear_upsample_pallas on the TPU side).
TIERS = {
    "resize": (dict(), (194, 640)),
    "pyramid-8": (dict(halation_size=3.0), (192, 640)),
}


@pytest.mark.parametrize("tier", list(TIERS))
def test_halation_tiers_match_jax_tpu_form(tier, tpu_form, monkeypatch):
    """The benchmark config on the two tiers, against the JAX TPU form with
    float32 MTF taps (see test_halation_render_matches_jax_tpu_form)."""
    from raw2film_tpu.ops import pallas_conv2

    orig = pallas_conv2.fused_sep_rank_mxu
    monkeypatch.setattr(
        pallas_conv2, "fused_sep_rank_mxu", lambda *a, **k: orig(*a, **dict(k, precision=None))
    )
    overrides, hw = TIERS[tier]
    jb, jcfg = _build(5472, 8208)
    jcfg = dataclasses.replace(jcfg, **overrides)
    worst, equal = _render_both(jb, jcfg, _codes(*hw, seed=10))
    print(f"{tier}: max {worst} code, {equal:.6f} of codes equal")
    assert tpu_form == []  # halation_mega declined: the glow came from halation_blur
    assert worst <= 1
    assert equal >= 0.999
