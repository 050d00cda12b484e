"""The pyramid resamples of the halation glow (kernels K10 and K12, their
plain versions on the CPU) against the JAX package's Pallas kernels in
interpret mode, on shapes their Pallas grids serve (not their XLA
fallbacks); and the port's lerp taps against the JAX lerp matrices."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import raw2film_tpu  # noqa: F401
from raw2film_tpu.ops import conv as jconv
from raw2film_tpu.ops import pallas_pyramid
from raw2film_tpu_torch.ops import pyramid

# K10 sums f x f float32 values and scales; K12 adds two weighted values.
# Both are held relative to the magnitude of the values (< 3).
DOWN_TOL = 1e-6
UP_TOL = 2e-6


@pytest.fixture
def pallas_calls(monkeypatch):
    """Counts the Pallas launches of pallas_pyramid, so a test can show the
    kernel, not its XLA fallback, served the call."""
    calls = []
    orig = pallas_pyramid.pl.pallas_call

    def counted(*args, **kwargs):
        calls.append(kwargs.get("grid"))
        return orig(*args, **kwargs)

    monkeypatch.setattr(pallas_pyramid.pl, "pallas_call", counted)
    return calls


def _img(shape, seed):
    return np.random.default_rng(seed).uniform(0.0, 3.0, shape).astype(np.float32)


# (input shape, f, chunk): f = 4 as in the halation pyramid, f = 3 (the
# Pallas grid needs h//f a multiple of 24 or 32 there), and remainders that
# both crop.
DOWN_CASES = {
    "f4": ((3, 64, 160), 4, 32),
    "f3": ((3, 96, 192), 3, 33),
    "f4-remainder": ((3, 66, 163), 4, 32),
    "f3-remainder": ((2, 98, 200), 3, 33),
}


@pytest.mark.parametrize("case", list(DOWN_CASES))
def test_box_downsample_matches_pallas(case, pallas_calls):
    shape, f, chunk = DOWN_CASES[case]
    x = _img(shape, 1)
    ref = np.asarray(pallas_pyramid.box_downsample_pallas(jnp.asarray(x), f, chunk=chunk, interpret=True))
    assert pallas_calls, "the Pallas kernel did not serve this shape"
    got = pyramid.box_downsample_pyramid(torch.from_numpy(x), f).numpy()
    assert got.shape == (shape[0], shape[1] // f, shape[2] // f) == ref.shape
    np.testing.assert_allclose(got, ref, rtol=DOWN_TOL, atol=0)


@pytest.mark.parametrize("oh", [None, 90, 96], ids=["full", "crop-90", "crop-96"])
def test_upsample_rows_matches_pallas(oh, pallas_calls):
    x = _img((3, 24, 40), 2)
    ref = np.asarray(pallas_pyramid.bilinear_upsample_rows_pallas(jnp.asarray(x), 4, oh=oh, interpret=True))
    assert pallas_calls, "the Pallas kernel did not serve this shape"
    got = pyramid.bilinear_upsample_rows(torch.from_numpy(x), 4, oh).numpy()
    assert got.shape == ref.shape == (3, oh or 96, 40)
    assert np.abs(got - ref).max() <= UP_TOL


def test_upsample_rows_other_factor_matches_resize():
    """f = 3 against jax.image.resize (the kernel's semantics: half-pixel
    centres, edge clamp), cropped."""
    x = _img((2, 7, 30), 3)
    ref = np.asarray(jconv.bilinear_upsample(jnp.asarray(x), (21, 30)))[:, :20]
    got = pyramid.bilinear_upsample_rows(torch.from_numpy(x), 3, 20).numpy()
    assert np.abs(got - ref).max() <= UP_TOL


@pytest.mark.parametrize("n_in,f,n_out", [(40, 4, 160), (2052, 4, 8208), (1500, 4, 6000), (9, 3, 25), (5, 4, 18)])
def test_lerp_taps_are_the_lerp_matrix_rows(n_in, f, n_out):
    i0, i1, w0, w1 = pyramid.lerp_taps(n_in, f, n_out)
    m = np.zeros((n_out, n_in), np.float32)
    np.add.at(m, (np.arange(n_out), i0), w0)
    np.add.at(m, (np.arange(n_out), i1), w1)
    np.testing.assert_array_equal(m, jconv._lerp_matrix_full(n_in, f)[:n_out])


def test_lerp_taps_match_the_halation_chunk_matrices():
    """The TPU halation kernel lerps each W-chunk with _lerp_matrix bands:
    first chunk clamped low, last chunk clamped high. Assembled over a
    3-chunk row they give the same weights as lerp_taps."""
    chunk, f, w = 64, 4, 160
    w4 = w // f
    last = w - 2 * chunk
    pieces = [
        (0, chunk, 0, pallas_pyramid._lerp_matrix(chunk, f, clamp_lo=True, clamp_hi=False)),
        (chunk, chunk, chunk // f - 1, pallas_pyramid._lerp_matrix(chunk, f, clamp_lo=False, clamp_hi=False)),
        (2 * chunk, last, 2 * chunk // f - 1, pallas_pyramid._lerp_matrix(last, f, clamp_lo=False, clamp_hi=True)),
    ]
    m = np.zeros((w, w4), np.float32)
    for c0, cw, lo, band in pieces:
        m[c0 : c0 + cw, lo : lo + band.shape[0]] = band.T[:cw]
    i0, i1, w0, w1 = pyramid.lerp_taps(w4, f, w)
    want = np.zeros_like(m)
    np.add.at(want, (np.arange(w), i0), w0)
    np.add.at(want, (np.arange(w), i1), w1)
    np.testing.assert_array_equal(m, want)


@pytest.mark.parametrize("bad", [dict(f=0), dict(oh=97)])
def test_upsample_rows_refuses(bad):
    args = dict(f=4, oh=None) | bad
    with pytest.raises(ValueError):
        pyramid.bilinear_upsample_rows(torch.zeros(3, 24, 40), **args)


# (input shape, f, out_hw): shapes whose Pallas grid serves the call (h > 16,
# w f >= 3 chunks of 512), cropped on both axes.
UP2D_CASES = {"f4": ((3, 20, 390), 4, (77, 1555)), "f8": ((2, 18, 200), 8, (141, 1597))}


@pytest.mark.parametrize("case", list(UP2D_CASES))
def test_upsample_matches_pallas(case, pallas_calls):
    shape, f, out_hw = UP2D_CASES[case]
    x = _img(shape, 4)
    ref = np.asarray(pallas_pyramid.bilinear_upsample_pallas(jnp.asarray(x), f, out_hw, interpret=True))
    assert pallas_calls, "the Pallas kernel did not serve this shape"
    got = pyramid.bilinear_upsample(torch.from_numpy(x), f, out_hw).numpy()
    assert got.shape == ref.shape == (shape[0], *out_hw)
    assert np.abs(got - ref).max() <= UP_TOL


@pytest.mark.parametrize("bad", [dict(f=0), dict(out_hw=(97, 40)), dict(out_hw=(40, 161))])
def test_upsample_refuses(bad):
    args = dict(f=4, out_hw=None) | bad
    with pytest.raises(ValueError):
        pyramid.bilinear_upsample(torch.zeros(3, 24, 40), **args)
