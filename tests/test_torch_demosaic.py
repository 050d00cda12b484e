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
