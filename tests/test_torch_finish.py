"""``Processor._finish``: a render that is resized back and takes no canvas
stays on its device through the resize, the clip and the cast, and leaves
it once as uint8; a host render (a canvas, the space-axis mesh) goes up once
as uint8 for the same device finish. Both are bit-equal to the JAX
Processor's finish (resized, then clipped and cast on the host). The resize
weights are uploaded once per shape. On the card (``-m cuda``), a
preview-shaped ``process()`` copies nothing up once warm and only its uint8
frame down, and ``PreviewEngine`` adds only the histogram's counts.

This file imports no JAX, so it runs on the card with ``--noconftest``."""

import threading

import numpy as np
import pytest
import torch

from raw2film_tpu_torch import PreviewEngine, Processor
from raw2film_tpu_torch.io.dng import write_dng
from raw2film_tpu_torch.ops import resize
from raw2film_tpu_torch.pipeline import canvas
from raw2film_tpu_torch.ops.histogram import generate_histogram
from raw2film_tpu_torch.utils import trace

STOCKS = dict(negative_film="Kodak Portra 400", print_film="Fuji Crystal Archive Maxima")
# The viewer's simplified preview, capped below the half-size decode: a
# 240 x 360 mosaic decodes to 120 x 180 (5 px/mm), renders at 48 x 72 and
# is resized back to 120 x 180 (Lanczos-5, x 2.5).
PREVIEW = dict(STOCKS, seed=3, max_scale=2.0, sharpness=False, grain=0, halation=False)


@pytest.fixture(autouse=True)
def _recording_off():
    trace.enable(False)
    trace.reset_stats()
    yield
    trace.enable(False)
    trace.reset_stats()


def _mosaic(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = 0.04 + 0.8 * (xx / w) * (0.3 + 0.7 * yy / h) + rng.uniform(0.0, 0.05, (h, w))
    return np.clip(m, 0.0, 1.0) * 60000


def _dng(directory, h=240, w=360):
    p = str(directory / "f.dng")
    write_dng(p, _mosaic(h, w), white_level=60000)
    return p


@pytest.fixture(scope="module")
def dng(tmp_path_factory):
    return _dng(tmp_path_factory.mktemp("finish"))


def _host_cast(render, orig_resolution, device="cpu"):
    """The JAX Processor's resize back of a (3, H, W) uint8 render: resized
    as float32 (on ``device``), then clipped and truncated to uint8 on the
    host, (H, W, 3)."""
    chw = render if isinstance(render, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(render))
    scaled = resize.resolution_scaling(chw.to(device, torch.float32), tuple(orig_resolution))
    return np.clip(scaled.cpu().numpy(), 0, 255).astype(np.uint8).transpose(1, 2, 0)


def _host_finish(monkeypatch):
    """Make every finish the JAX Processor's (no canvas): ``_host_cast`` of
    the render."""
    monkeypatch.setattr(Processor, "_finish", lambda self, out, orig_resolution=None, **kw:
                        _host_cast(out, orig_resolution, self.device))


def _tree_counts(tree):
    counts: dict = {}
    for s in tree:
        for k, v in (s.counts or {}).items():
            counts[k] = counts.get(k, 0) + v
    return counts


# (render (H, W), orig_resolution): the preview cell's Lanczos enlargement
# (x 2.78, ringing past [0, 255]), a fractional shrink, an integer shrink
# (K10's box mean), and odd sizes.
CASES = {
    "lanczos": ((36, 54), (100, 150)),
    "fractional": ((100, 150), (36, 54)),
    "integer": ((40, 60), (10, 15)),
    "odd": ((37, 53), (91, 131)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_device_finish_equals_host_finish(name):
    (h, w), orig = CASES[name]
    rng = np.random.default_rng(len(name))
    render = rng.integers(0, 256, (3, h, w)).astype(np.uint8)
    render[:, ::2, ::2] = 255  # hard edges, so the Lanczos case rings
    render[:, 1::3, 1::3] = 0
    want = _host_cast(render, orig)
    proc = Processor(device="cpu")
    for given in (render, torch.from_numpy(render)):  # a host render, a device render
        got = proc._finish(given, orig_resolution=orig)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(proc.last_frame_device.numpy(), got.transpose(2, 0, 1))
    assert proc._finish(render).shape == (h, w, 3) and proc.last_frame_device is None  # nothing resized
    if name == "lanczos":
        scaled = resize.resolution_scaling(torch.from_numpy(render).float(), orig)
        assert scaled.min() < 0 and scaled.max() > 255  # the clip does work


def test_staged_process_finishes_on_the_device(dng, monkeypatch):
    trace.enable(ranges=False)
    proc = Processor(device="cpu")
    got = proc.process(dng, **PREVIEW)
    (tree,) = trace.requests()
    names = [s.name for s in tree]
    assert got.shape == (120, 180, 3)
    assert _tree_counts(tree)["finish.device"] == 1 and trace.COUNTS["finish.device"] == 1
    assert {"finish", "finish.resize", "finish.cast", "finish.download"} <= set(names)
    assert "render.download" not in names and "finish.upload" not in names
    np.testing.assert_array_equal(proc.last_frame_device.numpy(), got.transpose(2, 0, 1))
    _host_finish(monkeypatch)
    np.testing.assert_array_equal(Processor(device="cpu").process(dng, **PREVIEW), got)


def test_a_canvas_goes_up_once_for_the_resize(dng, monkeypatch):
    """The canvas is added on the host, so the render comes down first and
    the canvas'd uint8 goes up once for the device finish (not counted as
    ``finish.device``); the codes are the JAX Processor's."""
    renders = []
    finish = Processor._finish
    monkeypatch.setattr(Processor, "_finish", lambda self, out, **kw: (renders.append(out), finish(self, out, **kw))[1])
    monkeypatch.setattr(trace, "on_host", lambda t: False)  # the CPU taken for a device
    trace.enable(ranges=False)
    proc = Processor(device="cpu")
    out = proc.process(dng, **PREVIEW, canvas_mode="Uniform white", canvas_scale=1.25)
    (tree,) = trace.requests()
    names = [s.name for s in tree]
    assert "finish.device" not in trace.COUNTS
    assert {"render.download", "finish.upload", "finish.resize", "finish.cast", "finish.download"} <= set(names)
    (render,) = renders
    framed = canvas.add_canvas(render.transpose(1, 2, 0), "Uniform white", 1.25)
    assert framed.shape[:2] == (66, 90)  # a border of 18 on the 48 x 72 render
    upload = next(s for s in tree if s.name == "finish.upload")
    assert upload.counts == {"copy.h2d.n": 1, "copy.h2d.bytes": framed.size}  # uint8
    np.testing.assert_array_equal(out, _host_cast(framed.transpose(2, 0, 1), (120, 180)))
    np.testing.assert_array_equal(proc.last_frame_device.numpy(), out.transpose(2, 0, 1))


def test_a_repeated_resize_copies_no_weights(monkeypatch):
    monkeypatch.setattr(trace, "on_host", lambda t: False)  # the CPU taken for a device
    img = torch.rand(3, 23, 31) * 255
    trace.COUNTS.clear()
    first = resize.resolution_scaling(img, (57, 77))
    assert trace.COUNTS.get("copy.h2d.bytes") == (23 * 57 + 31 * 77) * 4  # the two matrices, once
    trace.COUNTS.clear()
    again = resize.resolution_scaling(img, (57, 77))
    assert "copy.h2d.n" not in trace.COUNTS
    assert torch.equal(first, again)


# ------------------------------------------------------------ on the card


def _engine_frames(proc, src, n, **params):
    frames, errors = [], []
    done = threading.Semaphore(0)
    engine = PreviewEngine(proc, on_frame=lambda img, hist: (frames.append((img, hist)), done.release()),
                           on_error=lambda e: (errors.append(e), done.release()))
    try:
        for _ in range(n):
            engine.request(src, **params)
            assert done.acquire(timeout=600)
    finally:
        engine.close()
    assert not errors, errors
    return frames


@pytest.mark.cuda
def test_preview_copies_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on an NVIDIA GPU")
    src = _dng(tmp_path, 800, 1200)  # 400 x 600 decoded, rendered at 144 x 216
    h, w = 400, 600
    params = dict(PREVIEW, max_scale=6.0)
    proc = Processor(device="cuda")
    proc.process(src, **params)  # builds the kernels; caches the decode, bundle and weights
    torch.cuda.synchronize()
    trace.enable(ranges=False)
    got = proc.process(src, **params)
    torch.cuda.synchronize()
    (tree,) = trace.requests()
    counts = _tree_counts(tree)
    assert got.shape == (h, w, 3) and counts["finish.device"] == 1
    assert counts.get("copy.h2d.bytes", 0) == 0 and counts["copy.d2h.bytes"] == 3 * h * w
    assert proc.last_frame_device.is_cuda

    # Through the engine: the histogram counts the card's frame, so only
    # its 3 x 256 float32 counts come down besides the frame.
    trace.reset_stats()
    (_, (img, hist)) = _engine_frames(proc, src, 2, **params)
    counts = _tree_counts(trace.requests()[-1])
    assert counts.get("copy.h2d.bytes", 0) == 0 and counts["copy.d2h.bytes"] == 3 * h * w + 3 * 256 * 4
    np.testing.assert_array_equal(img, got)
    np.testing.assert_array_equal(hist, generate_histogram(img.transpose(2, 0, 1), device="cpu"))

    trace.enable(False)
    _host_finish(monkeypatch)
    np.testing.assert_array_equal(proc.process(src, **params), got)
