"""The port's demosaic (kernel K1's plain version on the CPU) against the JAX
package: the Pallas kernel in interpret mode, the XLA demosaic_exposure and
the XLA demosaic_mhc. All in float32; the three differ only in summation
order, so 2e-6 absolute on unit-range values (about 16 ulp at 1.0)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import raw2film_tpu  # noqa: F401
from raw2film_tpu.ops import demosaic as jdm
from raw2film_tpu.ops.pallas_demosaic import demosaic_mhc_pallas
from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.ops import demosaic as tdm

TOL = 2e-6
H, W = 48, 150  # tile_h 16 and chunk 128 in the Pallas reference: ragged last chunk
MAT = np.array([[0.9, 0.25, -0.1], [0.1, 1.05, -0.2], [-0.05, 0.2, 0.9]], np.float32)
NORM = np.array([256.0, 1.0 / 12000.0], np.float32)


def _inputs(kind):
    rng = np.random.default_rng(11)
    if kind == "f32":
        return rng.uniform(0.0, 1.0, (H, W)).astype(np.float32), None
    codes = rng.integers(0, 14000, (H, W)).astype(np.uint16)
    return codes, NORM


def _jax_normalized(x, norm):
    x = jnp.asarray(x)
    if norm is None:
        return x
    return jnp.clip((x.astype(jnp.float32) - norm[0]) * norm[1], 0.0, 1.0)


# Every pattern with and without the matrix, u16 codes with the matrix and
# float32 without (the Pallas interpret runs dominate this file's time);
# test_u16_equals_normalized_f32 covers the other two crossings.
CASES = [(p, True, "u16") for p in tdm.PATTERNS] + [(p, False, "f32") for p in tdm.PATTERNS]


@pytest.mark.parametrize(
    "pattern,with_mat,kind", CASES, ids=[f"{p}-{'mat' if m else 'rgb'}-{k}" for p, m, k in CASES]
)
def test_demosaic_matches_jax(pattern, with_mat, kind):
    x, norm = _inputs(kind)
    ry, rx = tdm.PATTERNS[pattern]
    jx = _jax_normalized(x, norm)
    if with_mat:
        got = tdm.demosaic_exposure(torch.from_numpy(x), pattern, MAT, norm=norm).numpy()
        refs = {
            "pallas": demosaic_mhc_pallas(jx, ry, rx, tile_h=16, chunk=128, interpret=True, mat=jnp.asarray(MAT)),
            "xla_exposure": jdm.demosaic_exposure(jx, pattern, jnp.asarray(MAT)),
        }
        rgb = jnp.clip(jdm.demosaic_mhc(jx, pattern), 0.0, 1.0)
        refs["xla_mhc"] = jnp.stack(
            [jnp.maximum(MAT[c, 0] * rgb[0] + MAT[c, 1] * rgb[1] + MAT[c, 2] * rgb[2], 0.0) for c in range(3)]
        )
    else:
        got = tdm.demosaic_mhc(torch.from_numpy(x), pattern, norm=norm).numpy()
        refs = {
            "pallas": demosaic_mhc_pallas(jx, ry, rx, tile_h=16, chunk=128, interpret=True),
            "xla_mhc": jdm.demosaic_mhc(jx, pattern),
        }
    assert got.shape == (3, H, W) and got.dtype == np.float32
    for name, ref in refs.items():
        err = np.abs(got - np.asarray(ref)).max()
        assert err <= TOL, (name, err)


@pytest.mark.parametrize("with_mat", [True, False], ids=["mat", "rgb"])
def test_u16_equals_normalized_f32(with_mat):
    codes, norm = _inputs("u16")
    f32 = tdm.normalize(torch.from_numpy(codes), norm)
    mat = MAT if with_mat else None
    for pattern in tdm.PATTERNS:
        ry, rx = tdm.PATTERNS[pattern]
        got = tdm.demosaic_kernel(torch.from_numpy(codes), ry, rx, mat, norm)
        assert torch.equal(got, tdm.demosaic_kernel(f32, ry, rx, mat))


def test_normalize_is_the_render_prologue():
    codes, norm = _inputs("u16")
    got = tdm.normalize(torch.from_numpy(codes), norm).numpy()
    np.testing.assert_array_equal(got, np.asarray(_jax_normalized(codes, norm)))


def test_small_frames_reflect_like_numpy():
    """Frames narrower than the stencil still reflect (numpy's repeated
    reflect-101), so the kernel's index arithmetic has a reference."""
    x = np.random.default_rng(2).uniform(0, 1, (3, 5)).astype(np.float32)
    got = tdm.demosaic_mhc(torch.from_numpy(x), "RGGB").numpy()
    ref = np.asarray(jdm.demosaic_mhc(jnp.asarray(x), "RGGB"))
    assert np.abs(got - ref).max() <= TOL


def _reflect101(i: int, n: int) -> int:
    """csrc/common.cuh::reflect101 (C's remainder, then the fold)."""
    if 0 <= i < n:
        return i
    if n == 1:
        return 0
    period = 2 * (n - 1)
    i = int(np.fmod(i, period))
    if i < 0:
        i += period
    return period - i if i >= n else i


def _k1_emulate(x: np.ndarray, ry: int, rx: int, mat, norm) -> np.ndarray:
    """K1 as csrc/demosaic.cu computes it, in numpy float32: the window
    staged by reflect101 and normalized while staging; runs of 2 rows x 4
    columns from an even row and column, whose site (row parity dy, column
    parity dx & 1 against the red site's ry, rx) picks the two interpolants
    it computes; the matrix epilogue."""
    h, w = x.shape
    hp, wp = -(-h // 2) * 2, -(-w // 4) * 4
    rows = [_reflect101(i, h) for i in range(-2, hp + 2)]
    cols = [_reflect101(i, w) for i in range(-2, wp + 2)]
    win = x[np.ix_(rows, cols)].astype(np.float32)
    if norm is not None:
        win = np.clip((win - np.float32(norm[0])) * np.float32(norm[1]), 0.0, 1.0)
    out = np.zeros((3, hp, wp), np.float32)
    e = 0.125
    for dy in range(2):
        for dx in range(4):

            def sh(oy, ox):  # window value at (run row + dy + oy, run column + dx + ox)
                return win[2 + dy + oy: 2 + dy + oy + hp: 2, 2 + dx + ox: 2 + dx + ox + wp: 4]

            m = sh(0, 0)
            h1 = sh(0, -1) + sh(0, 1)
            v1 = sh(-1, 0) + sh(1, 0)
            h2 = sh(0, -2) + sh(0, 2)
            v2 = sh(-2, 0) + sh(2, 0)
            dg = (sh(-1, -1) + sh(-1, 1)) + (sh(1, -1) + sh(1, 1))
            r_row, r_col = dy == ry, (dx & 1) == rx
            if r_row == r_col:  # R or B site: t_g and t_opp only
                hv2 = h2 + v2
                t_g = e * (4.0 * m + 2.0 * (h1 + v1) - hv2)
                t_opp = e * (6.0 * m + 2.0 * dg - 1.5 * hv2)
                rgb = (m, t_g, t_opp) if r_row else (t_opp, t_g, m)
            else:  # G site: t_row and t_col only
                t_row = e * (5.0 * m + 4.0 * h1 - dg - h2 + 0.5 * v2)
                t_col = e * (5.0 * m + 4.0 * v1 - dg - v2 + 0.5 * h2)
                rgb = (t_row, m, t_col) if r_row else (t_col, m, t_row)
            if mat is not None:
                r, g, b = (np.clip(q, 0.0, 1.0) for q in rgb)
                mt = [float(v) for v in np.asarray(mat, np.float32).reshape(9)]
                rgb = [np.maximum(mt[3 * c] * r + mt[3 * c + 1] * g + mt[3 * c + 2] * b, 0.0) for c in range(3)]
            for c in range(3):
                out[c, dy::2, dx::4] = rgb[c]
    return out[:, :h, :w]


@pytest.mark.parametrize("with_mat", [False, True], ids=["rgb", "mat"])
@pytest.mark.parametrize("kind", ["u16-norm", "f32"])
@pytest.mark.parametrize("pattern", list(tdm.PATTERNS))
@pytest.mark.parametrize("hw", [(48, 150), (37, 67), (3, 5), (2, 2), (5, 4)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_kernel_site_rule_matches_plain(pattern, kind, with_mat, hw):
    """The kernel's per-site arithmetic (compile-time Bayer sites, two
    interpolants each, reflect101 staging with the normalize) equals the
    plain version bit for bit on every pattern, on frames whose H and W are
    not multiples of the 2 x 4 run, down to 2 x 2 (reflect more than once)."""
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    if kind == "f32":
        x, norm = rng.uniform(0.0, 1.0, hw).astype(np.float32), None
    else:
        x, norm = rng.integers(0, 14000, hw).astype(np.uint16), NORM
    ry, rx = tdm.PATTERNS[pattern]
    mat = MAT if with_mat else None
    want = tdm.demosaic_plain(torch.from_numpy(x), ry, rx, mat, norm).numpy()
    np.testing.assert_array_equal(_k1_emulate(x, ry, rx, mat, norm), want)


def test_bad_pattern_raises():
    with pytest.raises(ValueError):
        tdm.demosaic_mhc(torch.zeros(8, 8), "RGBG")


def test_meta_tensor_has_no_kernel():
    with pytest.raises(ValueError):
        tdm.demosaic_mhc(torch.zeros(8, 8, device="meta"), "RGGB")
    assert kb.launches["demosaic"] == 0


# ------------------------------------------------------------ K11, X-Trans

HS_H, HS_W = 35, 131  # odd: the last row and column are dropped


@pytest.mark.parametrize("pattern", list(tdm.PATTERNS))
@pytest.mark.parametrize("kind", ["u16", "f32"])
def test_half_size_matches_pallas_bit_for_bit(pattern, kind):
    """K11's plain version against half_size_decode_pallas in interpret mode
    (chunk 64: three W-chunks, the last one 2 wide) and the XLA slices."""
    from raw2film_tpu.ops.pallas_pyramid import half_size_decode_pallas

    rng = np.random.default_rng(12)
    if kind == "u16":
        x, norm = rng.integers(0, 14000, (HS_H, HS_W)).astype(np.uint16), NORM
    else:
        x, norm = rng.uniform(0.0, 1.0, (HS_H, HS_W)).astype(np.float32), None
    ry, rx = tdm.PATTERNS[pattern]
    jx = _jax_normalized(x, norm)
    ref = half_size_decode_pallas(jx, ry, rx, chunk=64, interpret=True)
    assert ref is not None
    got = tdm.half_size_decode(torch.from_numpy(x), pattern, norm).numpy()
    assert got.shape == (3, HS_H // 2, HS_W // 2)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got, np.asarray(jdm.half_size_decode(jx, pattern)))


def test_half_size_refuses_tiny_frames():
    with pytest.raises(ValueError):
        tdm.half_size_decode(torch.zeros(1, 8), "RGGB")


def test_masked_demosaic_matches_jax():
    """The X-Trans decode: its depthwise convs as SVD ranks (the TPU form)
    against the JAX CPU form's dense shift-and-add convs."""
    from raw2film_tpu.io.raf import XTRANS_CANONICAL

    x = np.random.default_rng(13).uniform(0.0, 1.0, (40, 54)).astype(np.float32)
    ref = np.asarray(jdm.demosaic_masked(jnp.asarray(x), XTRANS_CANONICAL, 6, 6))
    got = tdm.demosaic_masked(torch.from_numpy(x), XTRANS_CANONICAL, 6, 6).numpy()
    assert np.abs(got - ref).max() <= 1e-5


@pytest.mark.parametrize("pattern", list(tdm.PATTERNS))
@pytest.mark.parametrize("hw", [(48, 150), (37, 67), (5, 4)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_bilinear_matches_jax(pattern, hw):
    """``demosaic_bilinear``: its two 3x3 stencils as SVD ranks (K2's plain
    version) against the JAX package's shift-and-add CPU form, within 1e-5
    (the rank split reorders a few float32 sums of unit-range values)."""
    x = np.random.default_rng(13).uniform(0.0, 1.0, hw).astype(np.float32)
    ref = np.asarray(jdm.demosaic_bilinear(jnp.asarray(x), pattern))
    got = tdm.demosaic_bilinear(torch.from_numpy(x), pattern)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # measured values stay at their own sites
    ry, rx = tdm.PATTERNS[pattern]
    np.testing.assert_array_equal(got.numpy()[0, ry::2, rx::2], x[ry::2, rx::2])
