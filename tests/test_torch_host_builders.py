"""The port's host-side numpy builders are exactly the JAX package's.

The port keeps its own copies of small numpy functions whose JAX-package
modules import JAX at module level; these must stay equal to the
originals, bit for bit, at the 45 MP scale (228 px/mm) and a small one.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import raw2film_tpu  # noqa: F401  (the real package, before the port's loader)
from __graft_entry__ import _build
from raw2film_tpu.film import chain as fchain
from raw2film_tpu.film.loader import load_film_stocks
from raw2film_tpu.ops import conv as jconv
from raw2film_tpu.ops import mtf as jmtf
from raw2film_tpu.ops import pallas_grain as jgrain
from raw2film_tpu.ops.pallas_print import pack_print_vec as jpack
from raw2film_tpu.pipeline import render as jrender
from raw2film_tpu_torch import convert, load_film_bundle, make_film_bundle
from raw2film_tpu_torch.ops import conv as tconv
from raw2film_tpu_torch.ops import grain as tgrain
from raw2film_tpu_torch.ops import mtf as tmtf
from raw2film_tpu_torch.ops.print_encode import pack_print_vec as tpack

SHAPES = {"45MP": (5472, 8208), "small": (448, 672)}


def _cfg(shape):
    return _build(*SHAPES[shape], halation=False)[1]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_mtf_kernel_and_svd_stack(shape):
    cfg = _cfg(shape)
    for strength in (0.0, 0.8):
        jk = jmtf.mtf_kernel(cfg.mtf_key, cfg.scale, strength, 1.0)
        tk = tmtf.mtf_kernel(cfg.mtf_key, cfg.scale, strength, 1.0)
        np.testing.assert_array_equal(tk, jk)
        for tol, rank in ((1e-4, 6), (2e-3, 4)):
            for got, want in zip(tmtf._svd_stack(tk, tol, rank), jmtf._svd_stack(jk, tol, rank)):
                np.testing.assert_array_equal(got, want)
    u3, v3 = tmtf.mtf_taps(cfg.mtf_key, cfg.scale)
    k = jmtf.mtf_kernel(cfg.mtf_key, cfg.scale)
    tol, rank = (1e-4, 6) if k.shape[-1] <= 15 else (2e-3, 4)
    np.testing.assert_array_equal(u3, jmtf._svd_stack(k, tol, rank)[0])
    np.testing.assert_array_equal(v3, jmtf._svd_stack(k, tol, rank)[1])
    if shape == "45MP":
        assert u3.shape == (3, 4, 23)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_svd_separable_and_gaussian(shape):
    cfg = _cfg(shape)
    k = jmtf.mtf_kernel(cfg.mtf_key, cfg.scale)
    for c in range(3):
        for tol, rank in ((1e-4, 6), (2e-3, 4)):
            for got, want in zip(tconv.svd_separable(k[c], tol, rank), jconv.svd_separable(k[c], tol, rank)):
                np.testing.assert_array_equal(got, want)
    sigma = tgrain.correlation_sigma_px(cfg.scale, cfg.grain_size_mm, cfg.grain_sigma)
    for s, trunc in ((sigma, 2.5), (3.0, 2.0), (1.7, 4.0)):
        np.testing.assert_array_equal(tconv.gaussian_kernel1d(s, trunc), jconv.gaussian_kernel1d(s, trunc))
    assert tgrain.grain_corr_taps(sigma) == jgrain.grain_corr_taps(sigma)
    if shape == "45MP":
        assert len(tgrain.grain_corr_taps(sigma)) == 3
    else:
        assert tgrain.grain_corr_taps(sigma) == (1.0,)


@pytest.mark.parametrize("n,f", [(49, 110), (74, 110), (46, 9), (42, 6), (3, 1)])
def test_resample_matrices(n, f):
    np.testing.assert_array_equal(tconv._lerp_matrix_full(n, f), jconv._lerp_matrix_full(n, f))
    np.testing.assert_array_equal(tconv._mean_matrix(n, f), jconv._mean_matrix(n, f))


def _jax_parts():
    stocks = load_film_stocks()
    neg, prt = stocks["Kodak Portra 400"], stocks["Fuji Crystal Archive Maxima"]
    neg_p = fchain.build_negative_params(neg)
    prt_p = fchain.build_print_params(neg, prt, neg_params=neg_p)
    out_p = fchain.build_output_params(neg, prt, prt_p, neg_p)
    return neg_p, prt_p, out_p


def _assert_bundles_equal(tb, jb):
    """The JAX bundle's keys and values, plus the host copies of ``m_in``
    (``m_in_host``), of K3's packed print vector (``pvec_host``) and of
    K16's development parameters (``develop_host``), all read-only float32,
    equal to the JAX values and to the device copies."""
    assert set(tb) == set(jb) | {"m_in_host", "pvec_host", "develop_host"}
    for key in ("m_in_host", "pvec_host", "develop_host"):
        host = tb[key]
        assert isinstance(host, np.ndarray) and host.dtype == np.float32 and not host.flags.writeable, key
    np.testing.assert_array_equal(tb["m_in_host"], np.asarray(jb["m_in"]))
    np.testing.assert_array_equal(tb["m_in_host"], tb["m_in"].cpu().numpy())
    np.testing.assert_array_equal(tb["pvec_host"], np.asarray(jpack(jb)))
    np.testing.assert_array_equal(tb["pvec_host"], tpack(tb).cpu().numpy())
    for b, as_np in ((jb, np.asarray), (tb, lambda t: t.cpu().numpy())):
        parts = [b["flare"], *b["neg_curve"], b["d_min"], b["mask"]]
        np.testing.assert_array_equal(tb["develop_host"], np.concatenate([as_np(t).reshape(-1) for t in parts]))
    for k, v in jb.items():
        if isinstance(v, tuple):
            assert len(tb[k]) == len(v)
            for a, b in zip(tb[k], v):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(v), err_msg=k)


def test_bundle_conversion_matches_port_builder():
    parts = _jax_parts()
    kw = dict(highlight_burn=0.3, d_ref_green=1.1, grain_rms=11.0, grain_shape=(1.2, 1.1, 0.2, 0.1, 3.0), sat=1.2)
    jb = jrender.make_film_bundle(*parts, **kw)
    tb = make_film_bundle(*parts, **kw)
    _assert_bundles_equal(tb, jb)
    _assert_bundles_equal(convert.bundle_from_numpy(jb), jb)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_load_film_bundle_matches_graft_build(shape):
    jb, jcfg = _build(*SHAPES[shape], halation=False)
    tb, tcfg = load_film_bundle(h=SHAPES[shape][0], w=SHAPES[shape][1], halation=False, grain=2, sharpness=True, highlight_burn=0.3, device="cpu")
    _assert_bundles_equal(tb, jb)
    assert tcfg == convert.config_from_jax(jcfg)
    np.testing.assert_array_equal(tpack(tb).numpy(), np.asarray(jpack(jb)))


def test_pack_print_vec_layout():
    rng = np.random.default_rng(3)
    jb = jrender.make_film_bundle(*_jax_parts(), highlight_burn=0.7, sat=0.8)
    jb = dict(jb, a=jnp.asarray(rng.normal(size=(3, 3)), jnp.float32))
    tb = convert.bundle_from_numpy(jb)
    got = tpack(tb)
    assert got.dtype == torch.float32 and got.shape == (61,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpack(jb)))
    np.testing.assert_array_equal(tb["pvec_host"], got.numpy())
    assert got[60] == np.float32(0.7) and got[59] == np.float32(0.8)


# Halation sizes: the 45 MP frame (57, 4 x 27 full-res taps, a /4 pyramid of
# two terms), the 24 MP frame (41.67, 4 x 43 taps, one pyramid term), and
# the two tiers below the mixture (20, 8).
HALATION_SIZES = [57.0, 41.67, 20.0, 8.0]


@pytest.mark.parametrize("size", HALATION_SIZES)
def test_halation_host_kernels(size):
    from raw2film_tpu.ops import halation as jhal
    from raw2film_tpu_torch.ops import halation as thal

    assert (thal.INNER_RADIUS, thal.PYRAMID_SIGMA) == (jhal.INNER_RADIUS, jhal.PYRAMID_SIGMA)
    np.testing.assert_array_equal(thal.exponential_blur_kernel(size), jhal.exponential_blur_kernel(size))
    got, want = thal.fit_gaussian_mixture(size), jhal.fit_gaussian_mixture(size)
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    np.testing.assert_array_equal(got[2], want[2])
    assert thal._full_res_ranks(size) == jhal._full_res_ranks(size)
    us, vs, by_factor = thal._full_res_ranks(size)
    for f, terms in by_factor.items():
        su, sv = thal.pyramid_taps(f, terms)
        # the list _pyramid_small_blur hands fused_sep_rank_mxu
        want_u = [w * jconv.gaussian_kernel1d(s / f, truncate=3.0) for s, w in terms]
        want_v = [jconv.gaussian_kernel1d(s / f, truncate=3.0) for s, _ in terms]
        for a, b in zip(su + sv, want_u + want_v):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if size == 57.0:
        assert [len(u) for u in us] == [27] * 4 and list(by_factor) == [4]
        assert [len(u) for u in thal.pyramid_taps(4, by_factor[4])[0]] == [15, 27]
    if size == 41.67:
        assert [len(u) for u in us] == [43] * 4 and len(by_factor[4]) == 1


def test_config_from_jax_carries_halation():
    """The benchmark config with halation on (the defaults of _build and
    load_film_bundle), and the halation fields of a changed JAX config."""
    import dataclasses

    jb, jcfg = _build(5472, 8208)
    tb, tcfg = load_film_bundle(grain=2, sharpness=True, highlight_burn=0.3, device="cpu")
    _assert_bundles_equal(tb, jb)
    assert tcfg == convert.config_from_jax(jcfg)
    assert (tcfg.halation, tcfg.halation_size, tcfg.bw) == (True, 1.0, False)
    other = convert.config_from_jax(dataclasses.replace(jcfg, halation_size=1.7, bw=True))
    assert (other.halation, other.halation_size, other.bw) == (True, 1.7, True)
