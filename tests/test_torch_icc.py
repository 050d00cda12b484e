"""The ICC output LUT through the port's Processor on the CPU.

An ICC display or soft-proof transform is baked on the host into a
CP-factored LUT over encoded RGB (``io/icc.py::bake_output_cp``) and
applied by the render after K3's float encode and before the 8-bit
rounding. Held within 1 code of the JAX Processor with the same transform,
run in its TPU form (``_use_pallas`` patched True and every ``pallas_call``
in interpret mode, inside the test only): a float callable on the staged
half-size path and on the fused full-res path, ``process_batch``, and an
ImageCms soft proof through PIL's built-in sRGB profile. Also the JAX
package's own ICC checks (tests/test_pipeline.py) on the port: the identity
transform within 1 code of no transform, the gradient transformed before
the rounding, and the factors uploaded once per transform object."""

import numpy as np
import pytest

import jax
import torch

import raw2film_tpu  # noqa: F401
from raw2film_tpu.io.dng import write_dng
from raw2film_tpu.pipeline import processor as jproc
from raw2film_tpu_torch import Processor
from raw2film_tpu_torch.io import icc as ticc

STOCKS = dict(negative_film="Kodak Portra 400", print_film="Fuji Crystal Archive Maxima")


def gamma_135(x):
    """The float transform of tests/test_pipeline.py's ICC case."""
    return np.clip(x, 0, 1) ** 1.35


@pytest.fixture(scope="module")
def port():
    return Processor(device="cpu")


@pytest.fixture(scope="module")
def jax_proc():
    return jproc.Processor()


@pytest.fixture(scope="module")
def dngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("icc")
    paths = []
    for i in range(2):
        rng = np.random.default_rng(40 + i)
        yy, xx = np.mgrid[0:96, 0:144]
        m = 0.04 + 0.8 * (xx / 144) * (0.3 + 0.7 * yy / 96) + rng.uniform(0.0, 0.05, (96, 144))
        p = str(d / f"i{i}.dng")
        write_dng(p, np.clip(m, 0.0, 1.0) * 60000, white_level=60000)
        paths.append(p)
    return paths


@pytest.fixture
def tpu_form(monkeypatch):
    """The JAX chain in its TPU form on the CPU (as tests/test_torch_render.py
    runs it); the XLA caches are cleared around the test."""
    from jax.experimental import pallas as pl

    from raw2film_tpu.ops import conv as jconv

    orig_call = pl.pallas_call
    jax.clear_caches()
    monkeypatch.setattr(jconv, "_use_pallas", lambda: True)
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: orig_call(*a, **dict(k, interpret=True)))
    yield
    jax.clear_caches()


def _diff(a: np.ndarray, b: np.ndarray) -> tuple[int, float]:
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), float((d == 0).mean())


# name -> process() overrides: the staged half-size default and the fused
# full-res path (the burn's small map on K3's prologue in the port, the
# staged burn in the JAX TPU form's ICC branch).
PATHS = {"staged": dict(), "fused": dict(half_size=False, max_scale=None)}


@pytest.mark.parametrize("path", list(PATHS))
def test_process_icc_matches_jax_tpu_form(path, port, jax_proc, dngs, tpu_form):
    kw = dict(STOCKS, seed=3, highlight_burn=0.3, icc_transform=gamma_135, **PATHS[path])
    want = jax_proc.process(dngs[0], **kw)
    got = port.process(dngs[0], **kw)
    worst, equal = _diff(got, want)
    print(f"{path}: {got.shape}, max {worst} code, {equal:.6f} of codes equal")
    assert worst <= 1
    assert (port._mosaic_cache[0] is not None) == (path == "fused")
    plain = port.process(dngs[0], **dict(kw, icc_transform=None))
    assert _diff(got, plain)[0] > 1  # the transform acts


def test_process_batch_icc_matches_jax_tpu_form(port, jax_proc, dngs, tpu_form):
    """The batch bakes once; image i takes the grain key of position i on
    both sides; image 0 equals a single process() call."""
    kw = dict(STOCKS, grain=2, half_size=False, max_scale=None, icc_transform=gamma_135)
    want = jax_proc.process_batch(dngs, seed=9, **kw)
    bakes = []
    orig = ticc.bake_output_cp
    fresh = Processor(device="cpu")
    try:
        ticc.bake_output_cp = lambda t: bakes.append(t) or orig(t)
        got = fresh.process_batch(dngs, seed=9, **kw)
    finally:
        ticc.bake_output_cp = orig
    assert bakes == [gamma_135]
    for g, w in zip(got, want):
        worst, equal = _diff(g, w)
        print(f"batch: max {worst} code, {equal:.6f} of codes equal")
        assert worst <= 1
    np.testing.assert_array_equal(got[0], fresh.process(dngs[0], seed=9, cache=False, **kw))


def test_softproof_imagecms_matches_jax_tpu_form(port, jax_proc, dngs, tmp_path, tpu_form):
    """A soft proof through PIL's built-in sRGB profile, written to a file
    and opened as tests/test_viewer.py does, built by each package's
    io/icc.py; the bake tabulates it through ImageCms in uint8."""
    ImageCms = pytest.importorskip("PIL.ImageCms")
    from raw2film_tpu.io import icc as jicc

    prof = str(tmp_path / "proof.icc")
    with open(prof, "wb") as f:
        f.write(ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes())
    kw = dict(STOCKS, seed=4)
    want = jax_proc.process(dngs[1], icc_transform=jicc.build_softproof_transform(prof), **kw)
    got = port.process(dngs[1], icc_transform=ticc.build_softproof_transform(prof), **kw)
    worst, equal = _diff(got, want)
    print(f"softproof: max {worst} code, {equal:.6f} of codes equal")
    assert worst <= 1
    # sRGB proofed to sRGB: the uint8 tabulation moves codes by at most 1
    assert _diff(got, port.process(dngs[1], **kw))[0] <= 1


def test_icc_baked_pre_quantization(port):
    """tests/test_pipeline.py::test_icc_baked_pre_quantization on the port:
    the identity transform is within 1 code of no transform; the transform
    applies to the unquantized encoded output (within 1 code of the float
    reference) and keeps at least as many levels on a fine gradient as a
    transform of the uint8 output would."""
    w = 512
    ramp = np.linspace(0.02, 0.9, w, dtype=np.float32)
    xyz = np.broadcast_to(ramp, (3, 16, w)).copy()
    kw = dict(print_film=None, grain=0, halation=False, sharpness=False, half_size=False, max_scale=None)
    off = port.process(xyz, "Kodak Portra 400", **kw)
    on = port.process(xyz, "Kodak Portra 400", icc_transform=gamma_135, **kw)
    ident = port.process(xyz, "Kodak Portra 400", icc_transform=lambda x: x, **kw)
    assert np.abs(ident.astype(int) - off.astype(int)).max() <= 1
    want = np.round(gamma_135(off.astype(np.float64) / 255.0) * 255.0)
    assert np.abs(on.astype(np.float64) - want).max() <= 1.0
    double_q = np.round(gamma_135(np.round(off[..., 0] / 255.0 * 255) / 255.0) * 255)
    assert len(np.unique(on[..., 0])) >= len(np.unique(double_q.astype(np.uint8)))


def test_factors_upload_once_per_transform(port, monkeypatch):
    """The CP factors are baked and put on the device once per transform
    object and reused by every later render; another transform object
    bakes anew."""
    bakes = []
    orig = ticc.bake_output_cp
    monkeypatch.setattr(ticc, "bake_output_cp", lambda t: bakes.append(t) or orig(t))
    proc = Processor(device="cpu")
    xyz = np.full((3, 8, 12), 0.2, np.float32)
    kw = dict(grain=0, halation=False, half_size=False, max_scale=None)
    first = proc._icc_arrays(gamma_135)
    for _ in range(2):
        proc.process(xyz, "Kodak Portra 400", icc_transform=gamma_135, **kw)
    assert bakes == [gamma_135]
    assert all(a is b for a, b in zip(proc._icc_arrays(gamma_135), first))
    assert all(isinstance(a, torch.Tensor) and a.device == proc.device for a in first)
    other = lambda x: x  # noqa: E731
    proc.process(xyz, "Kodak Portra 400", icc_transform=other, **kw)
    assert bakes == [gamma_135, other]
    assert proc._icc_arrays(None) is None
