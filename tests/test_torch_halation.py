"""Halation in the port against the JAX package: kernel K14's plain version
against ``halation_mega`` in interpret mode, the whole mixture tier against
the JAX Pallas pieces composed in interpret mode, the ragged-rank K2 small
blur, the two lower tiers against the JAX CPU form, and the mixture tier's
other branches (frames whose H or W is not a multiple of 4, the /8 level,
the glow alone) against the JAX Pallas pieces composed in interpret mode.

The ranks are the 45 MP benchmark config's (228 px/mm, size 57: 4 shared
ranks of 27 taps and a /4 pyramid of two Gaussians, 15 and 27 taps)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import raw2film_tpu  # noqa: F401
from __graft_entry__ import _build
from raw2film_tpu.ops import halation as jhal
from raw2film_tpu.ops import pallas_conv2, pallas_halation, pallas_pyramid
from raw2film_tpu_torch.convert import bundle_from_numpy
from raw2film_tpu_torch.ops import halation as thal
from raw2film_tpu_torch.ops import sep_rank

# K14 against halation_mega: exposure to 1e-5; density to 2e-5, since the
# port's and the JAX package's exp2/log2 differ by up to 16 ulp on the CPU
# (ROADMAP.md, queue 3) and the develop chain carries them.
EXPOSURE_TOL = 1e-5
DENSITY_TOL = 2e-5
SEP_TOL = 1e-5  # K2's plain version against fused_sep_rank_mxu

BUNDLE, CFG = _build(5472, 8208)
SIZE = CFG.scale / 4.0 * CFG.halation_size
US, VS, BY_FACTOR = thal._full_res_ranks(SIZE)
SU, SV = thal.pyramid_taps(4, BY_FACTOR[4])


def _np(a):
    return np.asarray(a)


TB = bundle_from_numpy({k: tuple(_np(a) for a in v) if isinstance(v, tuple) else _np(v) for k, v in BUNDLE.items()})


def _factors(bw: bool) -> np.ndarray:
    g = float(_np(BUNDLE["hal_green"]))
    f = [g, g, g] if bw else [1.0, g, 0.0]
    return (np.float32(_np(BUNDLE["hal_intensity"])) * np.asarray(f, np.float32)).astype(np.float32)


DEVVEC = np.concatenate(
    [_np(BUNDLE["flare"]).reshape(1)] + [_np(c).reshape(3) for c in BUNDLE["neg_curve"]]
).astype(np.float32)


def _img(shape, seed, hi=2.0):
    return np.random.default_rng(seed).uniform(0.0, hi, shape).astype(np.float32)


def test_config_shapes():
    assert SIZE == 57.0
    assert [len(u) for u in US] == [27] * 4 and list(BY_FACTOR) == [4]
    assert [len(u) for u in SU] == [15, 27] and DEVVEC.shape == (19,)


@pytest.mark.parametrize("develop", [False, True], ids=["exposure", "density"])
@pytest.mark.parametrize("bw", [False, True], ids=["colour", "bw"])
def test_halation_mega_matches_pallas(bw, develop):
    """The Pallas grid needs H % tile == 0, H > 2 tile and W > 2 chunk:
    tile 16, chunk 64 on 48 x 160 (three W-chunks, the last one short)."""
    h, w = 48, 160
    img = _img((3, h, w), 1)
    rows_up = _img((3, h, w // 4), 2, 0.5)
    fac = _factors(bw)
    dv = DEVVEC if develop else None
    ref = pallas_halation.halation_mega(
        jnp.asarray(img), list(US), list(VS), jnp.asarray(rows_up), jnp.asarray(fac),
        tile_h=16, chunk=64, interpret=True, develop=None if dv is None else jnp.asarray(dv),
    )
    assert ref is not None
    got = thal.halation_mega(
        torch.from_numpy(img), US, VS, torch.from_numpy(rows_up), torch.from_numpy(fac),
        None if dv is None else torch.from_numpy(dv),
    )
    err = np.abs(got.numpy() - np.asarray(ref)).max()
    print(f"bw={bw} develop={develop}: max abs difference {err}")
    assert err <= (DENSITY_TOL if develop else EXPOSURE_TOL)


def test_ragged_small_blur_matches_pallas():
    """K2 on the pyramid's ragged ranks (15 and 27 taps, the shorter one
    zero-padded symmetrically) against fused_sep_rank_mxu."""
    x = _img((3, 48, 96), 3)
    ref = pallas_conv2.fused_sep_rank_mxu(jnp.asarray(x), SU, SV, tile_h=16, chunk=32, interpret=True)
    assert ref is not None
    got = sep_rank.fused_sep_rank(torch.from_numpy(x), SU, SV).numpy()
    assert np.abs(got - np.asarray(ref)).max() <= SEP_TOL
    # the padding is exact: the same as summing the two ranks apart
    apart = sum(
        sep_rank.fused_sep_rank_plain(torch.from_numpy(x), [u], [v]) for u, v in zip(SU, SV)
    ).numpy()
    np.testing.assert_array_equal(got, apart)


def test_ragged_taps_must_be_odd():
    with pytest.raises(ValueError):
        sep_rank.fused_sep_rank(torch.zeros(1, 8, 8), [np.ones(3), np.ones(4)], [np.ones(3), np.ones(3)])


@pytest.fixture
def pallas_calls(monkeypatch):
    """Counts Pallas launches, so a test can show that the Pallas kernels,
    not their XLA fallbacks, served the JAX side."""
    calls = []
    orig = pallas_pyramid.pl.pallas_call

    def counted(*args, **kwargs):
        calls.append(kwargs.get("grid"))
        return orig(*args, **kwargs)

    monkeypatch.setattr(pallas_pyramid.pl, "pallas_call", counted)
    return calls


@pytest.mark.parametrize("develop", [False, True], ids=["exposure", "density"])
def test_combined_fused_matches_pallas_chain(develop, pallas_calls):
    """K10 -> K2 -> K12 -> K14 against box_downsample_pallas ->
    fused_sep_rank_mxu -> bilinear_upsample_rows_pallas -> halation_mega,
    each in interpret mode on a shape its Pallas grid serves (the /4 level
    is 40 x 40: K12's grid needs h/4 % 8 == 0, the MXU rank form h/4 > 33)."""
    h, w = 160, 160
    img = _img((3, h, w), 4)
    fac = _factors(False)
    ji = jnp.asarray(img)
    small = pallas_pyramid.box_downsample_pallas(ji, 4, chunk=32, interpret=True)
    small_blur = pallas_conv2.fused_sep_rank_mxu(small, SU, SV, tile_h=16, chunk=32, interpret=True)
    rows_up = pallas_pyramid.bilinear_upsample_rows_pallas(small_blur, 4, oh=h, interpret=True)
    ref = pallas_halation.halation_mega(
        ji, list(US), list(VS), rows_up, jnp.asarray(fac), tile_h=16, chunk=64,
        interpret=True, develop=jnp.asarray(DEVVEC) if develop else None,
    )
    assert ref is not None and len(pallas_calls) == 4
    got = thal.halation_combined_fused(
        torch.from_numpy(img), CFG.scale, CFG.halation_size, torch.from_numpy(fac),
        torch.from_numpy(DEVVEC) if develop else None,
    )
    err = np.abs(got.numpy() - np.asarray(ref)).max()
    print(f"develop={develop}: max abs difference {err}")
    assert err <= (DENSITY_TOL if develop else EXPOSURE_TOL)


# The lower tiers against the JAX CPU form. Below 12 the TPU (and the port)
# take the dense kernel's SVD ranks (tol 1e-4, rank <= 6) where the CPU form
# convolves the dense kernel itself; between 12 and 40 both take the same
# SVD ranks. Bounds: the measured differences on uniform [0, 1) images
# (0, 3.6e-7 and 0), with margin, far inside the 6e-3 halation tier
# contract (BENCHMARKS.md:334).
TIERS = {
    "size-1x1": (2.4, 0.0),  # size 0.6: a 1 x 1 kernel, a plain product
    "size-10": (40.0, 1e-6),  # size 10: 11 x 11 dense kernel, 6 ranks
    "size-20": (80.0, 1e-6),  # size 20: 21 x 21, the SVD tier (8 ranks)
}


@pytest.mark.parametrize("tier", list(TIERS))
def test_lower_tiers_match_jax_cpu(tier):
    scale, bound = TIERS[tier]
    img = _img((3, 40, 56), 5, 1.0)
    ref = np.asarray(jhal.halation_blur(jnp.asarray(img), scale, 1.0))
    got = thal.halation_blur(torch.from_numpy(img), scale, 1.0).numpy()
    err = np.abs(got - ref).max()
    print(f"{tier}: max abs difference {err}")
    assert err <= bound
    fac = _factors(False)
    ref = np.asarray(jhal.halation_with_factors(jnp.asarray(img), scale, 1.0, jnp.asarray(fac).reshape(3, 1, 1)))
    got = thal.halation_with_factors(torch.from_numpy(img), scale, 1.0, torch.from_numpy(fac)).numpy()
    assert np.abs(got - ref).max() <= bound + 1e-6


def _jax_tpu_glow(img: np.ndarray, size: float) -> np.ndarray:
    """The TPU form of halation_blur's mixture tier (halation.py:167-177),
    its Pallas pieces run in interpret mode: the full-res ranks, then per
    pyramid level the box downsample, the small blur and the 2-D upsample
    (which declines shapes that are not multiples of f, falling back to
    jax.image.resize)."""
    us, vs, by_factor = jhal._full_res_ranks(size)
    ji = jnp.asarray(img)
    blur = pallas_conv2.fused_sep_rank_mxu(ji, list(us), list(vs), interpret=True)
    for f, terms in by_factor.items():
        small = pallas_pyramid.box_downsample_pallas(ji, f, interpret=True)
        su, sv = thal.pyramid_taps(f, terms)
        small_blur = pallas_conv2.fused_sep_rank_mxu(small, su, sv, interpret=True)
        blur = blur + pallas_pyramid.bilinear_upsample_pallas(small_blur, f, img.shape[-2:], interpret=True)
    return np.asarray(blur)


# (frame, halation size): the branches that needed K13 before it was ported.
K13_CASES = {
    "h-not-multiple-of-4": ((3, 70, 128), 1.0),  # the bilinear resize, scale 70 / 17
    "w-not-multiple-of-4": ((3, 72, 126), 1.0),
    "pyramid-factor-8": ((3, 168, 200), 3.0),  # size 171: the /4 and /8 levels on K13
    "glow-alone": ((3, 72, 128), 1.0),
}


@pytest.mark.parametrize("case", list(K13_CASES))
def test_branches_needing_k13_raise(case):
    """Once NotImplementedError naming K13, each branch now renders as the
    TPU does: halation_combined_fused returns None (as the JAX one does) and
    halation_blur builds the glow, held to the JAX Pallas pieces."""
    shape, hsize = K13_CASES[case]
    size = CFG.scale / 4.0 * hsize
    img = _img(shape, 7)
    fac = _factors(False)
    if case == "pyramid-factor-8":
        assert list(thal._full_res_ranks(size)[2]) == [4, 8]
    if case != "glow-alone":
        assert thal.halation_combined_fused(torch.from_numpy(img), CFG.scale, hsize, torch.from_numpy(fac)) is None
    ref = _jax_tpu_glow(img, size)
    if case == "glow-alone":
        got = thal.halation_blur(torch.from_numpy(img), CFG.scale, hsize).numpy()
    else:
        f = fac.reshape(3, 1, 1)
        ref = (img + f * ref) / (1.0 + f)
        got = thal.halation_with_factors(torch.from_numpy(img), CFG.scale, hsize, torch.from_numpy(fac)).numpy()
    err = np.abs(got - ref).max()
    print(f"{case}: max abs difference {err}")
    assert err <= EXPOSURE_TOL


def test_below_mixture_tier_returns_none():
    assert thal.halation_combined_fused(torch.rand(3, 8, 8), 80.0, 1.0, torch.ones(3)) is None


def test_develop_vector_layout():
    """The 19 floats the render packs, read back per channel as K14 reads
    them: [flare, dmin*3, gamma*3, x_toe*3, x_shoulder*3, w_toe*3, w_shoulder*3]."""
    from raw2film_tpu_torch.pipeline.render import _hd_plane

    x = torch.from_numpy(_img((3, 4, 5), 6, 1.5))
    got = thal.develop_density(x, torch.from_numpy(DEVVEC))
    for c in range(3):
        lx = thal.fm.log10(torch.clamp(x[c] + TB["flare"], min=1e-6))
        np.testing.assert_array_equal(got[c].numpy(), _hd_plane(lx, TB["neg_curve"], c).numpy())


@pytest.mark.parametrize("bw", [False, True], ids=["colour", "bw"])
def test_factor_and_develop_vectors_match_the_jax_render(bw):
    """What the render packs for K14, against the JAX render's construction
    (render.py:227-244), from the same bundle."""
    np.testing.assert_array_equal(thal.colour_factors(TB, bw).numpy(), _factors(bw))
    np.testing.assert_array_equal(thal.develop_vector(TB).numpy(), DEVVEC)
