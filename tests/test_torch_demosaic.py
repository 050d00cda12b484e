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
