"""The port's LUT ops (``raw2film_tpu_torch/ops/lut.py``) against the JAX
package's (``raw2film_tpu/ops/lut.py``) on the CPU, on seeded numpy inputs:
the 2-D chromaticity LUT, the two 1-D curve applies and the tetrahedral 3-D
LUT within 2e-6 absolute, the factor interpolation and the CP-factored apply
within 1e-5 (on every band split of the port's apply), the host CP fit bit
for bit with its source pinned, and the CP apply's memory: no tensor
larger than its output, so never the (H, W, 3, r) or (H, W, r) products the
JAX form writes for XLA to fuse."""

import inspect

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from torch.profiler import ProfilerActivity, profile

import raw2film_tpu  # noqa: F401
from raw2film_tpu.io import icc as jicc
from raw2film_tpu.ops import lut as jlut
from raw2film_tpu_torch.io import icc as ticc
from raw2film_tpu_torch.ops import lut as tlut

TOL_EXACT = 2e-6
TOL_CP = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got: torch.Tensor, want, tol: float) -> float:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    err = float(np.abs(got.numpy().astype(np.float64) - want).max())
    print(f"max abs err {err!r} (tol {tol})")
    assert err <= tol
    return err


def test_apply_lut_2d_matches_jax():
    """Positive XYZ with black pixels (the S < 1e-12 shortcut) and pixels on
    both triangles of their cell; max abs error measured 0."""
    rng = _rng(1)
    img = rng.uniform(0.0, 1.0, (3, 24, 40)).astype(np.float32)
    img[:, :3, :5] = 0.0
    lut = rng.uniform(0.0, 1.0, (17, 17, 3)).astype(np.float32)
    want = jlut.apply_lut_2d(jnp.asarray(img), jnp.asarray(lut))
    _close(tlut.apply_lut_2d(torch.from_numpy(img), torch.from_numpy(lut)), want, TOL_EXACT)


@pytest.mark.parametrize("form", ["gather", "onehot"])
def test_apply_curve_1d_matches_jax(form):
    """Inputs beyond both ends of the curve's domain; the curve resampled
    from a non-uniform grid by the copied host helper (equal to JAX's).
    Max abs error measured 0 (gather) and 1.2e-7 (one-hot)."""
    rng = _rng(2)
    x = np.sort(rng.uniform(-2.0, 1.0, 40))
    curve = np.stack([x, *(np.cumsum(rng.uniform(0, 0.1, (3, 40)), axis=1))])
    x_min, x_max, table = tlut.resample_curve_uniform(curve, n=64)
    want_host = jlut.resample_curve_uniform(curve, n=64)
    assert (x_min, x_max) == want_host[:2]
    np.testing.assert_array_equal(table, want_host[2])
    img = rng.uniform(-2.5, 1.5, (3, 20, 30)).astype(np.float32)
    jf, tf = {"gather": (jlut.apply_curve_1d, tlut.apply_curve_1d),
              "onehot": (jlut.apply_curve_1d_onehot, tlut.apply_curve_1d_onehot)}[form]
    want = jf(jnp.asarray(img), x_min, x_max, jnp.asarray(table))
    _close(tf(torch.from_numpy(img), x_min, x_max, torch.from_numpy(table)), want, TOL_EXACT)


@pytest.mark.parametrize("scale", [0.25, 1.0])
def test_apply_lut_3d_tetrahedral_matches_jax(scale):
    """Every tetrahedron, values below 0 and beyond the last cell (the
    upper-edge fraction of 1). Max abs error measured 0."""
    rng = _rng(3)
    img = rng.uniform(-0.1, 1.15 / scale, (3, 32, 48)).astype(np.float32)
    lut = rng.uniform(0.0, 1.0, (9, 9, 9, 3)).astype(np.float32)
    want = jlut.apply_lut_3d_tetrahedral(jnp.asarray(img), jnp.asarray(lut), scale=scale)
    _close(tlut.apply_lut_3d_tetrahedral(torch.from_numpy(img), torch.from_numpy(lut), scale=scale),
           want, TOL_EXACT)


@pytest.mark.parametrize("shape", [(33, 24), (33, 3, 24)])
def test_interp_factor_matches_jax(shape):
    rng = _rng(4)
    coords = rng.uniform(0.0, 32.0, (16, 20)).astype(np.float32)
    coords[0, :3] = (0.0, 31.0, 32.0)
    factor = rng.normal(0.5, 0.3, shape).astype(np.float32)
    want = jlut._interp_factor(jnp.asarray(coords), jnp.asarray(factor))
    _close(tlut._interp_factor(torch.from_numpy(coords), torch.from_numpy(factor)), want, TOL_EXACT)


def _factors(kind: str):
    """(u, v, w_bc, scale): random rank-24 factors on 33 points, or the
    bake of the ICC branch's float transform (rank 24, encoded RGB)."""
    if kind == "random":
        rng = _rng(5)
        u, v = (rng.normal(0.5, 0.3, (33, 24)).astype(np.float32) for _ in range(2))
        return u, v, rng.normal(0.5, 0.3, (33, 3, 24)).astype(np.float32), 0.25
    u, v, w, _ = ticc.bake_output_cp(lambda x: np.clip(x, 0, 1) ** 1.35)
    return u, v, w, 1.0


@pytest.fixture(scope="module")
def baked():
    return _factors("baked")


# Band sizes of the port's apply: one band; bands that split rows; bands
# smaller than a row, the last one ragged.
BANDS = [tlut.CP_BAND_PIXELS, 1000, 37]


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("kind", ["random", "baked"])
def test_apply_lut_3d_cp_matches_jax(kind, band, baked, monkeypatch):
    """Max abs error measured 9.5e-7 on the random factors (outputs up to
    5.5) and 3.0e-7 on the baked ones, for every band size."""
    u, v, w, scale = baked if kind == "baked" else _factors(kind)
    rng = _rng(6)
    img = rng.uniform(-0.1, 1.1 / scale, (3, 41, 67)).astype(np.float32)
    want = jlut.apply_lut_3d_cp(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v), jnp.asarray(w), scale=scale)
    monkeypatch.setattr(tlut, "CP_BAND_PIXELS", band)
    got = tlut.apply_lut_3d_cp(*(torch.from_numpy(a) for a in (img, u, v, w)), scale=scale)
    _close(got, want, TOL_CP)


def test_fit_lut3d_cp_is_the_original():
    """The host fit is a copy: same source, and bit-equal factors and error
    for the same LUT and seed (a smooth transform and a noisy LUT)."""
    assert inspect.getsource(tlut.fit_lut3d_cp) == inspect.getsource(jlut.fit_lut3d_cp)
    rng = _rng(7)
    g = np.linspace(0.0, 1.0, 9, dtype=np.float32)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1)
    for lut, rank, seed in ((grid ** 1.35, 8, 0), (grid + 0.05 * rng.standard_normal(grid.shape), 6, 3)):
        want = jlut.fit_lut3d_cp(lut, rank=rank, iters=20, seed=seed)
        got = tlut.fit_lut3d_cp(lut, rank=rank, iters=20, seed=seed)
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        assert got[3] == want[3]


def test_bake_output_cp_matches_jax(baked):
    """io/icc.py's bake (a copy) gives the JAX package's factors bit for
    bit, with a fit error far below one code."""
    want = jicc.bake_output_cp(lambda x: np.clip(x, 0, 1) ** 1.35)
    for a, b in zip(baked[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert want[3] < 1e-3


def test_apply_lut_3d_cp_allocates_no_rank_products(baked):
    """On a 3 x 512 x 768 frame the apply's largest allocation is at most
    its output (3 planes): the JAX form's (H, W, 3, r) product is 72 planes
    at rank 24 and its (H, W, r) factors 24. Measured: 3 planes (the
    output, and the band's coordinates); band temporaries 1 plane each."""
    u, v, w, _ = baked
    rng = _rng(8)
    img = torch.from_numpy(rng.uniform(0.0, 1.0, (3, 512, 768)).astype(np.float32))
    args = [torch.from_numpy(a) for a in (u, v, w)]
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        out = tlut.apply_lut_3d_cp(img, *args, scale=1.0)
    plane = 512 * 768 * 4
    largest = max(e.cpu_memory_usage for e in prof.events())
    print(f"largest allocation {largest} bytes = {largest / plane} planes")
    assert tuple(out.shape) == (3, 512, 768)
    assert 0 < largest <= 3 * plane
