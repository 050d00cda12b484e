"""The port's Processor on the CPU: the seven goldens of tests/test_golden.py
within 1 code, and ``process()`` / ``process_batch()`` against the JAX
Processor on the same synthetic DNGs within 1 code, on both paths (the
half-size staged default, the fused full-res path, a staged full-res frame
whose H is not a multiple of 4), with the grain branches K8, K9 and K7
(grain mode 3), chroma NR and a rotated preview-scale frame. Also the
host pieces it relies on (the Threefry grain key, the crop windows), the
cache keyed on the file, and the JAX PreviewEngine and BatchRunner driving
the port Processor by injection, and ``process_batch`` over a device mesh
(repeated CPU devices) against the unsharded batch and the JAX Processor on
its virtual mesh."""

import os
import threading

import numpy as np
import pytest

import jax
import torch

import raw2film_tpu  # noqa: F401
from raw2film_tpu.data import XYZ_TO_REC709
from raw2film_tpu.io.dng import write_dng
from raw2film_tpu.pipeline import processor as jproc
from raw2film_tpu.pipeline.batch import BatchRunner
from raw2film_tpu.pipeline.preview import PreviewEngine
from raw2film_tpu_torch import Processor
from raw2film_tpu_torch.ops import demosaic as tdm
from raw2film_tpu_torch.parallel.mesh import make_mesh
from raw2film_tpu_torch.pipeline import processor as tproc
from test_golden import CASES as GOLDEN_CASES
from test_golden import COMMON, GOLDEN_DIR, _scene

STOCKS = dict(negative_film="Kodak Portra 400", print_film="Fuji Crystal Archive Maxima")


@pytest.fixture(scope="module")
def port():
    return Processor(device="cpu")


@pytest.fixture(scope="module")
def jax_proc():
    return jproc.Processor()


def _diff(a: np.ndarray, b: np.ndarray) -> tuple[int, float]:
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), float((d == 0).mean())


def _golden(name: str, out: np.ndarray) -> None:
    want = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    worst, equal = _diff(out, want)
    print(f"golden {name}: max {worst} code, {equal:.6f} of codes equal")
    assert worst <= 1


# ------------------------------------------------------------ goldens


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_render(name, port):
    out = port.process(_scene(), **GOLDEN_CASES[name], **COMMON)
    assert out.shape == (64, 96, 3)
    _golden(name, out)


def test_golden_raf_end_to_end(port, tmp_path):
    """The RAF golden's file (tests/test_golden.py:90-114): compressed
    X-Trans, the masked decode, full res."""
    from raw_fixtures import write_raf

    from raw2film_tpu.io.raf import XTRANS_CANONICAL

    h, w = 66, 96
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(7)
    m = np.clip(
        1400 + 9000 * (xx / w) * (0.4 + 0.6 * yy / h) + rng.integers(0, 120, (h, w)), 0, 16383
    ).astype(np.uint16)
    p = str(tmp_path / "g.raf")
    write_raf(p, m, xtrans=XTRANS_CANONICAL, compressed=True, block_size=96)
    _golden("raf_xtrans", port.process(p, **STOCKS, **COMMON))


def test_golden_cr3_end_to_end(port, tmp_path):
    """The CR3 golden's file (tests/test_golden.py:128-150): Bayer, full res,
    the fused path."""
    from raw_fixtures import write_cr3_raw

    h, w = 64, 96
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(11)
    m = np.clip(
        900 + 11000 * (yy / h) * (0.3 + 0.7 * xx / w) + rng.integers(0, 200, (h, w)), 0, 16383
    ).astype(np.uint16)
    p = str(tmp_path / "g.cr3")
    write_cr3_raw(p, m, levels=2)
    _golden("cr3_crx", port.process(p, **STOCKS, **COMMON))


# ------------------------------------------------------------ against JAX


def _mosaic(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = 0.04 + 0.8 * (xx / w) * (0.3 + 0.7 * yy / h) + rng.uniform(0.0, 0.05, (h, w))
    return np.clip(m, 0.0, 1.0) * 60000


@pytest.fixture(scope="module")
def dngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dng")
    paths = []
    for i in range(3):
        p = str(d / f"f{i}.dng")
        write_dng(p, _mosaic(96, 144, i), white_level=60000, iso=200 * (i + 1))
        paths.append(p)
    return paths


# name -> process() overrides, and whether the fused path takes the render
VS_JAX = {
    "half-size": (dict(), False),
    "fused": (dict(half_size=False, max_scale=None), True),
    "rotation": (dict(half_size=False, max_scale=None, rotation=3.0), False),
    "sharpness-off": (dict(sharpness=False), False),
    "bw-grain": (dict(grain=1), False),
    "chroma-nr": (dict(chroma_nr=3), False),
    "grain-3": (dict(grain=3), False),
    "portrait-preview": (dict(max_scale=15.0, rotate_times=1), False),
}


@pytest.mark.parametrize("name", list(VS_JAX))
def test_process_matches_jax(name, port, jax_proc, dngs):
    extra, fused = VS_JAX[name]
    kw = dict(STOCKS, seed=5, highlight_burn=0.3, **extra)
    want = jax_proc.process(dngs[0], **kw)
    got = port.process(dngs[0], **kw)
    worst, equal = _diff(got, want)
    print(f"{name}: {got.shape}, max {worst} code, {equal:.6f} of codes equal")
    assert worst <= 1
    assert (port._mosaic_cache[0] is not None) == fused
    if name == "rotation":
        assert got.shape[0] % 4 != 0
    assert port.last_metadata == jax_proc.last_metadata


def test_process_batch_matches_jax(port, jax_proc, dngs):
    """Image i takes the key fold_in(PRNGKey(seed), i) on both sides; image
    0 equals a single process() call."""
    kw = dict(STOCKS, grain=2, half_size=False, max_scale=None)
    want = jax_proc.process_batch(dngs, seed=9, **kw)
    got = port.process_batch(dngs, seed=9, **kw)
    for g, w in zip(got, want):
        assert _diff(g, w)[0] <= 1
    np.testing.assert_array_equal(got[0], port.process(dngs[0], seed=9, cache=False, **kw))
    assert not np.array_equal(got[1], port.process(dngs[1], seed=9, cache=False, **kw))


def test_process_batch_on_a_mesh_matches(port, jax_proc, dngs):
    """Three full-res staged frames (96 x 144, under the 400 px/mm cap: no
    resize) on a batch-only mesh of two CPU devices, one host thread a batch
    row: bit-equal to the unsharded batch on the staged path, and within 1
    code of the JAX Processor on a mesh of four virtual devices. Image i
    keeps its key fold_in(PRNGKey(seed), i)."""
    from raw2film_tpu.parallel.mesh import make_mesh as jax_make_mesh

    kw = dict(STOCKS, grain=2, highlight_burn=0.3, half_size=False)
    srcs = [dngs[0], dngs[1], dngs[0]]
    got = port.process_batch(srcs, seed=4, mesh=make_mesh(devices=["cpu"] * 2), **kw)
    want = port.process_batch(srcs, seed=4, fused_decode=False, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[2])  # same image, its own grain key
    jmesh = jax_make_mesh(4, batch=4, space=1)
    for g, w in zip(got, jax_proc.process_batch(srcs, seed=4, mesh=jmesh, **kw)):
        assert _diff(g, w)[0] <= 1


# ------------------------------------------------------------ host pieces


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2**31 - 1, -1, -5, 123456789])
def test_fold_in_matches_jax_random(seed):
    base = jax.random.PRNGKey(seed)
    assert tproc.prng_key(seed) == tuple(int(v) for v in np.asarray(base))
    for i in (0, 1, 2, 5, 1000):
        want = tuple(int(v) for v in np.asarray(jax.random.fold_in(base, i)))
        key = tproc.fold_in(tproc.prng_key(seed), i)
        assert key == want
        assert tproc.grain_seed(key) == want[0] ^ want[1]


SHAPES = [(64, 96), (96, 64), (66, 96), (97, 131), (100, 100), (5472, 8208), (5470, 8208), (41, 67)]
ASPECTS = [1.5, 1.0, 4 / 3, 36 / 23.9, 0.667, 16 / 9]


@pytest.mark.parametrize("aspect", ASPECTS)
def test_crop_windows_match_jax(aspect):
    for h, w in SHAPES:
        assert tproc._aspect_crop_window(h, w, aspect) == jproc._aspect_crop_window(h, w, aspect)
        assert tproc._staged_crop_window(h, w, aspect) == jproc._staged_crop_window(h, w, aspect)
        if h * w < 10**5:
            m = np.arange(h * w, dtype=np.uint16).reshape(h, w)
            got, want = tproc._mosaic_aspect_crop(m, aspect), jproc._mosaic_aspect_crop(m, aspect)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]


@pytest.mark.parametrize("pattern", ["RGGB", "GBRG"])
def test_half_size_xyz_matches_jax(pattern):
    m = np.random.default_rng(27).integers(200, 16000, (41, 67)).astype(np.uint16)
    cam = np.linalg.inv(np.asarray(XYZ_TO_REC709)).astype(np.float32)
    args = (m, pattern, cam, 256.0, 1.0 / 15000.0)
    np.testing.assert_array_equal(tdm.half_size_xyz(*args), jproc._half_size_xyz(*args))


def test_cache_follows_the_file(tmp_path):
    """The decode and mosaic caches are keyed on (path, mtime_ns, size): a
    file rewritten in place renders anew."""
    proc = Processor(device="cpu")
    p = str(tmp_path / "x.dng")
    kw = dict(STOCKS, grain=0, halation=False)
    for half in (True, False):
        write_dng(p, _mosaic(48, 72, 1), white_level=60000)
        first = proc.process(p, half_size=half, max_scale=None if not half else 400.0, **kw)
        write_dng(p, _mosaic(64, 96, 2), white_level=60000)
        st = os.stat(p)
        os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
        second = proc.process(p, half_size=half, max_scale=None if not half else 400.0, **kw)
        assert second.shape != first.shape
        fresh = Processor(device="cpu").process(p, half_size=half, max_scale=None if not half else 400.0, **kw)
        np.testing.assert_array_equal(second, fresh)


def test_refusals(port, dngs):
    # a mesh renders (it was refused until parallel/mesh.py was ported): a
    # space-sharded batch of one at the half-size default
    mesh = make_mesh(devices=["cpu"] * 2, batch=1, space=2)
    out = port.process_batch(dngs[:1], mesh=mesh, **STOCKS)
    assert len(out) == 1 and out[0].shape == (48, 72, 3) and out[0].dtype == np.uint8
    # chroma NR renders on the staged path (the fused path declines it)
    assert port.process(dngs[0], chroma_nr=2, half_size=False, max_scale=None, **STOCKS).shape == (96, 144, 3)
    assert port._mosaic_cache[0] is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Processor()


# ------------------------------------------------------------ injection


def test_preview_engine_drives_the_port(port, jax_proc, dngs):
    """The JAX PreviewEngine (simplified preview: no MTF, grain or
    halation) with the port Processor injected."""
    frames, errors = [], []
    done = threading.Event()
    engine = PreviewEngine(
        port, on_frame=lambda img, hist: (frames.append(img), done.set()),
        on_error=lambda e: (errors.append(e), done.set()),
    )
    try:
        engine.request(dngs[1], seed=3, **STOCKS)
        assert done.wait(timeout=120)
    finally:
        engine.close()
    assert not errors, errors
    want = jax_proc.process(dngs[1], seed=3, sharpness=False, grain=0, halation=False, **STOCKS)
    assert _diff(frames[0], want)[0] <= 1


def test_batch_runner_drives_the_port(port, jax_proc, dngs):
    out = {}
    runner = BatchRunner(port.process, lambda img, src: out.setdefault(src, img) is img and src)
    params = dict(STOCKS, seed=4, half_size=False, max_scale=None)
    results = runner.run([(p, params) for p in dngs[:2]])
    assert all(r.ok for r in results), results
    for p in dngs[:2]:
        assert _diff(out[p], jax_proc.process(p, **params))[0] <= 1
