"""The port's separable-rank conv with the grain epilogue (kernel K2's plain
version on the CPU) against the JAX package, and its grain hash against
the JAX hash bit for bit.

Taps are the 45 MP main path's: per-channel (3, 4, 23) MTF ranks and the
3-tap grain correlation (sigma 0.547 px)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import raw2film_tpu  # noqa: F401
from __graft_entry__ import _build
from raw2film_tpu.ops import mtf as jmtf
from raw2film_tpu.ops import pallas_conv2, pallas_grain
from raw2film_tpu_torch.ops import grain as tgrain
from raw2film_tpu_torch.ops import mtf as tmtf
from raw2film_tpu_torch.ops.conv import svd_separable
from raw2film_tpu_torch.ops import sep_rank

TOL = 1e-5
# Bound against film_sharpness_grain_from_key, whose "dc" precision rescales
# every tap vector so its bf16 rounding keeps the DC gain, a perturbation the
# port does not carry. Measured on this input (densities in [0, 3]): 1.78e-3.
DC_TOL = 3e-3

CFG = _build(5472, 8208, halation=False)[1]
U3, V3 = tmtf.mtf_taps(CFG.mtf_key, CFG.scale)
SIGMA = tgrain.correlation_sigma_px(CFG.scale, CFG.grain_size_mm, CFG.grain_sigma)
GTAPS = tgrain.grain_corr_taps(SIGMA)
PRM = np.array([0.03, 0.15, 0.31, 2.2, 0.12, 0.28], np.float32)
SEED, ROW_OFF = 0x9E3779B9 ^ 12345, 37


def _density(h, w, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 3.0, (3, h, w)).astype(np.float32)


def _jax_grain():
    return (jnp.asarray([SEED, ROW_OFF], jnp.uint32), jnp.asarray(PRM), SIGMA)


def _port_grain():
    return ((SEED, ROW_OFF), torch.from_numpy(PRM), GTAPS)


def test_main_path_taps():
    assert U3.shape == (3, 4, 23) and V3.shape == (3, 4, 23)
    assert len(GTAPS) == 3


def test_matches_fused_sep_rank_mxu_with_grain():
    """Per-channel (3, 4, 23) ranks and the 3-tap grain epilogue; the Pallas
    grid tiles H exactly here (its in-kernel edge reflection)."""
    d = _density(160, 300)
    ref = pallas_conv2.fused_sep_rank_mxu(
        jnp.asarray(d), U3, V3, precision=None, chunk=256, interpret=True, grain=_jax_grain()
    )
    assert ref is not None
    got = sep_rank.fused_sep_rank(torch.from_numpy(d), U3, V3, _port_grain())
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= TOL


def test_shared_taps_match_padded():
    """Shared taps, no epilogue, and an H the Pallas grid pads (its
    pre-reflected halo bands). Two 7-tap ranks keep the interpret run short."""
    k = np.outer([1, 3, 6, 8, 6, 3, 1], [1, 2, 5, 9, 5, 2, 1]).astype(np.float64)
    k += 0.05 * np.random.default_rng(5).normal(size=k.shape)
    u, v = svd_separable(k / k.sum(), tol=1e-6, max_rank=2)
    d = _density(150, 300, 1)
    ref = pallas_conv2.fused_sep_rank_mxu(jnp.asarray(d), list(u), list(v), precision=None, chunk=256, interpret=True)
    got = sep_rank.fused_sep_rank(torch.from_numpy(d), u, v)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= TOL


def test_matches_film_sharpness_grain_from_key():
    """The TPU entry point, with its bf16 "dc" tap rescale, within DC_TOL."""
    d = _density(288, 300, 2)
    seed, prm, sigma = _jax_grain()
    ref = jmtf.film_sharpness_grain_from_key(
        jnp.asarray(d), CFG.mtf_key, CFG.scale, 0.0, 1.0, seed, sigma, prm, interpret=True
    )
    assert ref is not None
    got = tmtf.film_sharpness_grain(
        torch.from_numpy(d), CFG.mtf_key, CFG.scale, 0.0, 1.0, (SEED, ROW_OFF), SIGMA,
        torch.from_numpy(PRM),
    ).numpy()
    err = np.abs(got - np.asarray(ref)).max()
    print(f"max abs difference to the dc-rescaled TPU form: {err}")
    assert err <= DC_TOL, err


def _jax_words(h, w, x0, y0, ch, seed, row_off):
    """The JAX grain hash's two words, built as grain_field_hash and the
    Pallas grain_field_block build them (int32 coordinates bitcast to
    uint32, the channel salt ch * -1640531527 in int32)."""
    bc = jax.lax.bitcast_convert_type
    yy = jnp.arange(y0, y0 + h, dtype=jnp.int32)[:, None] * jnp.ones((1, w), jnp.int32)
    xx = jnp.arange(x0, x0 + w, dtype=jnp.int32)[None, :] * jnp.ones((h, 1), jnp.int32)
    z = jnp.full((h, w), ch, jnp.int32) * np.int32(-1640531527)
    sd = pallas_grain.seed2(jnp.uint32(seed), row_off)
    a, b, _ = pallas_grain._pcg3d(bc(xx, jnp.uint32), bc(yy, jnp.uint32) + sd[1], bc(z, jnp.uint32) + sd[0])
    return np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64)


@pytest.mark.parametrize(
    "x0,y0,ch,seed,row_off",
    [(0, 0, 0, 0, 0), (8150, 5430, 2, 0xFFFFFFFF, 0), (3, 17, 1, 0xDEADBEEF, -5), (70000, 90000, 2, 7, 2**31 - 3)],
)
def test_hash_words_bit_exact(x0, y0, ch, seed, row_off):
    a, b = tgrain.hash_words(24, 40, x0, y0, ch, seed, row_off)
    ja, jb = _jax_words(24, 40, x0, y0, ch, seed, row_off)
    np.testing.assert_array_equal(a.numpy(), ja)
    np.testing.assert_array_equal(b.numpy(), jb)


@pytest.mark.parametrize("sigma", [SIGMA, 0.1, 1.3], ids=["45MP", "white", "wide"])
def test_grain_field_matches_grain_field_hash(sigma):
    taps = tgrain.grain_corr_taps(sigma)
    got = tgrain.grain_field_hash(SEED, (40, 56), taps, ROW_OFF).numpy()
    ref = np.asarray(pallas_grain.grain_field_hash(jnp.asarray([SEED, ROW_OFF], jnp.uint32), (40, 56), sigma))
    assert np.abs(got - ref).max() <= 1e-6
    if len(taps) == 1:
        np.testing.assert_array_equal(got, ref)  # the normals themselves


def test_grain_amplitude_matches_render_form():
    """The six-float amplitude vector, built from the bundle as the JAX
    render builds it (render.py:284-301)."""
    bundle, cfg = _build(5472, 8208, halation=False)
    prm = tgrain.grain_params(
        torch.tensor(np.asarray(bundle["grain_rms"])),
        torch.tensor(np.asarray(bundle["grain_shape"])),
        cfg.scale,
    )
    peak, width, floor, d_lo, d_hi = (bundle["grain_shape"][i] for i in range(5))
    rng = jnp.maximum(d_hi - d_lo, 1e-3)
    rms_eff = (bundle["grain_rms"] / 1000.0) * (48.0 / (1000.0 / cfg.scale))
    want = [rms_eff, floor, peak / rng * 0.5, 1.0 / (width * 0.35), d_lo, 1.0 / rng]
    np.testing.assert_array_equal(prm.numpy(), np.asarray([np.float32(w) for w in want]))
    d = _density(8, 16, 3)
    amp = tgrain.grain_amplitude(torch.from_numpy(d), prm).numpy()
    t = (d - d_lo) / rng
    ref = rms_eff * (floor + (1 - floor) * jnp.exp(-0.5 * ((t - peak / rng * 0.5 - 0.25) / (width * 0.35)) ** 2))
    assert np.abs(amp - np.asarray(ref)).max() <= 1e-6


# ------------------------------------------------------------ K8, K9


@pytest.mark.parametrize("sigma", [SIGMA, 1.3], ids=["45MP", "wide"])
@pytest.mark.parametrize("bw", [False, True], ids=["colour", "bw"])
def test_grain_apply_matches_pallas(bw, sigma):
    """K8 / K9's plain version against grain_apply_pallas /
    grain_apply_bw_pallas in interpret mode. H = 70 is not a multiple of the
    Pallas tile (64 colour, 32 black and white), so the TPU form pads H with
    edge rows; the hash depends on position only, so the port does not."""
    d = _density(70, 96, 4)
    fn = pallas_grain.grain_apply_bw_pallas if bw else pallas_grain.grain_apply_pallas
    ref = np.asarray(fn(jnp.asarray(d), jnp.asarray([SEED, ROW_OFF], jnp.uint32), sigma, *PRM, interpret=True))
    got = tgrain.grain_apply(torch.from_numpy(d), (SEED, ROW_OFF), sigma, torch.from_numpy(PRM), bw=bw)
    assert got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max()
    print(f"bw={bw} sigma={sigma}: max abs difference {err}")
    assert err <= TOL


def test_grain_apply_refuses():
    with pytest.raises(ValueError):
        tgrain.grain_apply(torch.zeros(1, 8, 8), (0, 0), SIGMA, torch.from_numpy(PRM), bw=True)
    with pytest.raises(ValueError):
        tgrain.grain_apply(torch.zeros(3, 8, 8), (0, 0), 20.0, torch.from_numpy(PRM))


# ------------------------------------------------------------ K7


@pytest.mark.parametrize("sigma", [SIGMA, 0.1, 1.3], ids=["45MP", "white", "wide"])
@pytest.mark.parametrize("bw", [False, True], ids=["colour", "bw"])
def test_grain_field_matches_pallas(bw, sigma):
    """K7's plain version against grain_field_pallas in interpret mode, on
    an H (70) that its 64-row tile pads; the seed is the seed2 pair, passed
    through unchanged. Black and white: one field broadcast to 3 channels."""
    ref = np.asarray(pallas_grain.grain_field_pallas(
        jnp.asarray([SEED, ROW_OFF], jnp.uint32), (70, 96), sigma, bw=bw, interpret=True))
    got = tgrain.grain_field((SEED, ROW_OFF), (70, 96), sigma, bw=bw, device="cpu")
    assert tuple(got.shape) == ref.shape == (3, 70, 96)
    assert np.abs(got.numpy() - ref).max() <= TOL
    if bw:
        assert torch.equal(got[0], got[2])


def test_generate_grain_field_and_apply_grain_match_jax():
    """The entry points around K7: the JAX key's two words give the seed
    (key[0] ^ key[1]); apply_grain adds the stock's amplitude times the
    field, clipped at 0."""
    from raw2film_tpu.film.loader import load_film_stocks as jstocks
    from raw2film_tpu.ops import grain as jgrain
    from raw2film_tpu_torch.film.loader import load_film_stocks as tstocks

    key = jax.random.PRNGKey(21)
    kw = dict(scale=120.0, grain_size_mm=0.006, grain_sigma=0.9)
    ref = np.asarray(jgrain.generate_grain_field(key, (37, 50), **kw))
    pair = tuple(int(v) for v in np.asarray(key))
    got = tgrain.generate_grain_field(pair, (37, 50), **kw, device="cpu").numpy()
    assert np.abs(got - ref).max() <= TOL
    d = _density(37, 50, 5)
    for bw in (False, True):
        ref = np.asarray(jgrain.apply_grain(jnp.asarray(d), key, jstocks()["Kodak Portra 400"],
                                            bw_grain=bw, **kw))
        got = tgrain.apply_grain(torch.from_numpy(d), pair, tstocks()["Kodak Portra 400"],
                                 bw_grain=bw, **kw).numpy()
        assert np.abs(got - ref).max() <= TOL
