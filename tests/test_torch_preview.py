"""The interactive slice on the CPU against the JAX package: chroma NR
(``ops/chroma_nr.py``), the histogram (``ops/histogram.py``: counts equal,
the strip equal) and the ``PreviewEngine`` over the port Processor against
the JAX engine over the JAX Processor, on the portrait 15 px/mm full preview
(a 540 x 360 frame, where the TPU runs K4) and the 30 px/mm simplified one."""

import threading

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import raw2film_tpu  # noqa: F401
from raw2film_tpu.io.dng import write_dng
from raw2film_tpu.ops import chroma_nr as jnr
from raw2film_tpu.ops import histogram as jhist
from raw2film_tpu.pipeline import preview as jpreview
from raw2film_tpu.pipeline import processor as jproc
from raw2film_tpu_torch import PreviewEngine, Processor
from raw2film_tpu_torch.ops import chroma_nr as tnr
from raw2film_tpu_torch.ops import histogram as thist

STOCKS = dict(negative_film="Kodak Portra 400", print_film="Fuji Crystal Archive Maxima")


@pytest.mark.parametrize("size", [1, 3, 6])
def test_chroma_nr_matches_jax(size):
    xyz = np.abs(np.random.default_rng(size).normal(0.3, 0.2, (3, 41, 67))).astype(np.float32)
    xyz[:, :2, :3] = 0.0  # black pixels take the EPS guards
    ref = np.asarray(jnr.chroma_nr(jnp.asarray(xyz), size))
    got = tnr.chroma_nr(torch.from_numpy(xyz), size).numpy()
    assert np.abs(got - ref).max() <= 1e-6
    np.testing.assert_array_equal(tnr.cv_gaussian_kernel1d(2 * size + 1, 1.1),
                                  jnr._cv_gaussian_kernel1d(2 * size + 1, 1.1))


# (H, W): exact counts, and a frame above MAX_SAMPLES (stride 2, counts x4).
@pytest.mark.parametrize("hw", [(37, 53), (800, 701)], ids=["exact", "strided"])
def test_histogram_matches_jax(hw):
    img = np.random.default_rng(3).integers(0, 256, (3, *hw)).astype(np.uint8)
    img[1] //= 3  # uneven channels
    want = np.asarray(jhist.histogram_counts(jnp.asarray(img)))
    got = thist.histogram_counts(torch.from_numpy(img)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(thist.generate_histogram(img, 64, device="cpu"),
                                  jhist.generate_histogram(img, 64))


def _mosaic(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = 0.04 + 0.8 * (xx / w) * (0.3 + 0.7 * yy / h) + rng.uniform(0.0, 0.05, (h, w))
    return np.clip(m, 0.0, 1.0) * 60000


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    """A 720 x 1080 DNG: the half-size decode is 360 x 540, the portrait
    frame at 15 px/mm 540 x 360 (W = 360, below K2's 512 px chunk)."""
    p = str(tmp_path_factory.mktemp("pv") / "pv.dng")
    write_dng(p, _mosaic(720, 1080, 4), white_level=60000, iso=400)
    return p


def _run(engine_cls, proc, src, **params):
    frames, errors = [], []
    done = threading.Event()
    engine = engine_cls(proc, on_frame=lambda img, hist: (frames.append((img, hist)), done.set()),
                        on_error=lambda e: (errors.append(e), done.set()))
    try:
        engine.request(src, **params)
        assert done.wait(timeout=300)
    finally:
        engine.close()
    assert not errors, errors
    return frames[0]


# name -> request parameters
PREVIEWS = {
    "full-15-portrait": dict(full_preview=True, max_scale=15.0, rotate_times=1),
    "simplified-30": dict(max_scale=30.0),
}


@pytest.mark.parametrize("name", list(PREVIEWS))
def test_preview_engine_matches_jax(name, frame):
    params = dict(STOCKS, seed=3, highlight_burn=0.3, **PREVIEWS[name])
    img, hist = _run(PreviewEngine, Processor(device="cpu"), frame, **params)
    jimg, jh = _run(jpreview.PreviewEngine, jproc.Processor(), frame, **params)
    assert img.shape == jimg.shape and img.dtype == np.uint8
    if name == "full-15-portrait":
        assert img.shape == (540, 360, 3)
    diff = np.abs(img.astype(np.int32) - jimg.astype(np.int32))
    print(f"{name}: {img.shape}, max {diff.max()} code, {(diff == 0).mean():.6f} of codes equal")
    assert diff.max() <= 1
    # Each engine's strip is the histogram of its own frame, and both
    # packages count the same frame identically.
    np.testing.assert_array_equal(hist, jhist.generate_histogram(img.transpose(2, 0, 1)))
    np.testing.assert_array_equal(jh, jhist.generate_histogram(jimg.transpose(2, 0, 1)))
    if (diff == 0).all():
        np.testing.assert_array_equal(hist, jh)


def test_preview_engine_logs_its_stages(frame):
    """The engine times its render and histogram with ``utils/trace.py``'s
    stage timer, as the JAX engine does: both land in the stage log
    (``stage_stats``) that the CLI's ``--trace`` reads, under the JAX
    engine's names. The port records only while recording is on, and its
    log holds the Processor's spans too, inside the engine's request tree
    (``preview.frame`` over ``process``): so the JAX engine's names and
    counts are among the port's stages, not all of them."""
    from raw2film_tpu.utils import trace as jtrace
    from raw2film_tpu_torch.utils import trace as ttrace

    params = dict(STOCKS, seed=3, **PREVIEWS["simplified-30"])
    want = {"preview.render": 1, "preview.histogram": 1}
    ttrace.enable(ranges=False)
    try:
        for trace, engine_cls, proc in ((ttrace, PreviewEngine, Processor(device="cpu")),
                                        (jtrace, jpreview.PreviewEngine, jproc.Processor())):
            trace.reset_stats()
            _run(engine_cls, proc, frame, **params)
            stats = trace.stage_stats()
            assert {k: stats[k]["count"] for k in want if k in stats} == want
            assert all(stats[k]["last_ms"] > 0 for k in want)
            if trace is ttrace:
                (tree,) = trace.requests()
                names = [s.name for s in tree]
                assert names[0] == "preview.frame" and {"process", "render", "finish"} <= set(names)
                process = next(s for s in tree if s.name == "process")
                render = next(s for s in tree if s.name == "preview.render")
                assert process.parent == render.id and render.parent == tree[0].id
    finally:
        ttrace.enable(False)
        ttrace.reset_stats()


def test_preview_histogram_counts_the_frame_left_on_the_device(frame, monkeypatch):
    """A preview capped below the decode (144 x 216 rendered, resized back
    to 360 x 540) finishes on the device: its histogram counts the frame the
    Processor kept there, so nothing goes up for it, and neither the render
    nor the finish makes a host round trip. The strip is the histogram of
    the image handed to ``on_frame``."""
    from raw2film_tpu_torch.utils import trace

    params = dict(STOCKS, seed=3, max_scale=6.0)
    proc = Processor(device="cpu")
    _run(PreviewEngine, proc, frame, **params)  # decodes and caches
    monkeypatch.setattr(trace, "on_host", lambda t: False)  # the CPU taken for a device
    trace.reset_stats()
    trace.enable(ranges=False)
    try:
        img, hist = _run(PreviewEngine, proc, frame, **params)
        (tree,) = trace.requests()
    finally:
        trace.enable(False)
        trace.reset_stats()
    names = [s.name for s in tree]
    assert img.shape == (360, 540, 3)
    assert "finish.upload" not in names and "render.download" not in names
    histogram = next(s for s in tree if s.name == "preview.histogram")
    assert histogram.counts == {"copy.d2h.n": 1, "copy.d2h.bytes": 3 * 256 * 4}
    finish = [s for s in tree if s.name == "finish"]
    assert [s.counts for s in finish] == [{"finish.device": 1}]
    assert proc.last_frame_device is None  # the engine took it
    np.testing.assert_array_equal(hist, thist.generate_histogram(img.transpose(2, 0, 1), device="cpu"))
