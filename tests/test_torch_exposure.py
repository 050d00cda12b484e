"""The fused path's exposure estimate on the CPU
(``ops/demosaic.py::exposure_power_mean``; kernel K15 on the card).

- A numpy model of K15 (its items, grid-stride threads, green rule, float32
  terms without FMA, float64 sums in the kernel's order) against the host
  estimate ``calc_exposure(half_size_xyz(...))``: within 2e-6 relative on
  the gain, for the four Bayer phases, even and odd frames, clipped and
  saturated sites, the EXIF exponent and its fallback, uint16 and float32
  data, both of K15's paths.
- The wrapper on CPU tensors: the host estimate bit for bit.
- A fused ``process()`` on the CPU: the uint8 frame the fused path gave
  before the estimate moved onto the uploaded mosaic.
- The prep's host integral check (counter ``prep.integral_check``): not
  run on a 16-bit strip, which the reader hands over as uint16; run once
  on integral float32 codes; the same codes uploaded either way.
- The aspect crop cut from a tensor: the host crop's window and values.

K15 itself is held to the host estimate on the card in
tests/test_torch_cuda.py."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from raw2film_tpu_torch import Processor
from raw2film_tpu_torch.data import XYZ_TO_REC709
from raw2film_tpu_torch.io import dng
from raw2film_tpu_torch.io.raw import calc_exposure, exif_factor
from raw2film_tpu_torch.ops import demosaic as dm
from raw2film_tpu_torch.pipeline import processor as tproc
from raw2film_tpu_torch.utils import trace
from test_torch_processor import ASPECTS, SHAPES

STOCKS = dict(negative_film="Kodak Portra 400", print_film="Fuji Crystal Archive Maxima")
CAM = np.linalg.inv(np.asarray(XYZ_TO_REC709, np.float64)).astype(np.float32)
BLACK, INV_RANGE = 512.0, 1.0 / (24000.0 - 512.0)
EXIF = {"EXIF:ISO": 100, "EXIF:ExposureTime": 1 / 125, "EXIF:FNumber": 4.0}
THREADS = 256  # K15's block


def _codes(h, w, seed, dtype=np.uint16):
    """Sensor codes with black-clipped and saturated sites: a ramp from
    below black to above white, with texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = 300.0 + 26000.0 * (xx / w) * (0.2 + 0.8 * yy / h) * rng.uniform(0.6, 1.4, (h, w))
    m = np.clip(m, 0, 65535)
    return m.astype(np.uint16) if dtype == np.uint16 else (m + rng.uniform(0, 1, (h, w))).astype(np.float32)


def _host_gain(m, pattern, metadata):
    """The fused path's gain before K15: the host half-size decode and
    ``calc_exposure``."""
    xyz = dm.half_size_xyz(m, pattern, CAM, BLACK, INV_RANGE)
    return np.float32(2.0 ** calc_exposure(xyz, metadata=metadata))


def _warp_sum(v):
    """__shfl_down_sync's tree over the last axis (32 lanes): lane 0's sum."""
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o : 2 * o]
    return v[..., 0]


def _k15_model(m, pattern, factor, vec):
    """(K15's float64 sum, its terms in sample order), computed as the
    kernel does: each item a 16-byte chunk of rows 4i and 4i + 1 (vec) or
    one sample, items strided over EXPOSURE_BLOCKS x 256 threads, each
    thread's sum in item order, the block's sum by warp trees, the partials
    summed by one warp."""
    ry, rx = dm.PATTERNS[pattern]
    h, w = m.shape
    n_i, n_j = (h // 2 + 1) // 2, (w // 2 + 1) // 2
    f32 = np.float32

    def unit(p):
        return np.clip((p.astype(f32) - f32(BLACK)) * f32(INV_RANGE), f32(0), f32(1))

    a0, a1 = unit(m[0 : 4 * n_i : 4, 0 : 4 * n_j : 4]), unit(m[0 : 4 * n_i : 4, 1 : 4 * n_j : 4])
    b0, b1 = unit(m[1 : 4 * n_i : 4, 0 : 4 * n_j : 4]), unit(m[1 : 4 * n_i : 4, 1 : 4 * n_j : 4])
    cells = {(0, 0): a0, (0, 1): a1, (1, 0): b0, (1, 1): b1}
    r, b = cells[(ry, rx)], cells[(1 - ry, 1 - rx)]
    g = (a1 + b0) * f32(0.5) if ry == rx else b1
    c0, c1, c2 = CAM[1]
    y = (c0 * r + c1 * g) + c2 * b
    terms = np.power(np.maximum(y, f32(1e-9)), f32(1.0 / factor)).astype(np.float64)  # (n_i, n_j)

    per_item = 2 if vec and m.dtype == np.uint16 else 1  # samples in an item
    items = terms.reshape(n_i, n_j // per_item, per_item).reshape(-1, per_item)
    blocks = min(dm.EXPOSURE_BLOCKS, -(-len(items) // THREADS))
    stride = blocks * THREADS
    padded = np.zeros((-(-len(items) // stride) * stride, per_item))
    padded[: len(items)] = items
    acc = np.zeros(stride)
    for row in padded.reshape(-1, stride, per_item):  # each thread's items in order
        for s in range(per_item):
            acc = acc + row[:, s]
    warps = _warp_sum(acc.reshape(blocks, THREADS // 32, 32))
    partial = _warp_sum(np.pad(warps, ((0, 0), (0, 32 - THREADS // 32))))
    lanes = np.zeros(32)
    for k0 in range(0, blocks, 32):
        chunk = partial[k0 : k0 + 32]
        lanes[: len(chunk)] = lanes[: len(chunk)] + chunk
    return _warp_sum(lanes), terms


CASES = [(41, 67), (42, 66), (37, 80), (64, 96), (2, 2), (3, 9)]


@pytest.mark.parametrize("dtype", [np.uint16, np.float32], ids=["u16", "f32"])
@pytest.mark.parametrize("metadata", [EXIF, None], ids=["exif", "fallback"])
@pytest.mark.parametrize("pattern", list(dm.PATTERNS))
def test_k15_model_matches_the_host_estimate(pattern, metadata, dtype):
    factor = exif_factor(metadata)
    assert factor == (math.sqrt(4.0**2 / 100 / (1 / 125)) + 1.0 if metadata else 3.0)
    for h, w in CASES:
        m = _codes(h, w, h * w, dtype)
        want = _host_gain(m, pattern, metadata)
        xyz = dm.half_size_xyz(m, pattern, CAM, BLACK, INV_RANGE)
        lum = np.maximum(xyz[1, ::2, ::2], np.float32(1e-9))
        for vec in (False, True) if w % (8 if dtype == np.uint16 else 4) == 0 else (False,):
            total, terms = _k15_model(m, pattern, factor, vec)
            # the same samples, and the same Y as the host decode's
            assert terms.shape == lum.shape and terms.size == dm.exposure_samples(h, w)
            np.testing.assert_allclose(terms, lum ** np.float32(1.0 / factor), rtol=1e-6)
            avg = (total / terms.size) ** factor
            got = np.float32(2.0 ** math.log2(0.18 / max(avg, 1e-9)))
            assert abs(got / want - 1.0) <= 2e-6, (h, w, vec, got, want)


def test_frame_has_clipped_and_saturated_sites():
    u = (_codes(64, 96, 1).astype(np.float32) - BLACK) * INV_RANGE
    assert (u < 0).mean() > 0.01 and (u > 1).mean() > 0.01


@pytest.mark.parametrize("dtype", [np.uint16, np.float32], ids=["u16", "f32"])
@pytest.mark.parametrize("pattern", list(dm.PATTERNS))
def test_wrapper_on_the_cpu_is_the_host_estimate(pattern, dtype):
    factor = exif_factor(EXIF)
    norm = np.asarray([BLACK, INV_RANGE], np.float32)
    for h, w in CASES:
        m = _codes(h, w, 7, dtype)
        got = dm.exposure_power_mean(torch.from_numpy(m), pattern, CAM, norm, factor)
        xyz = dm.half_size_xyz(m, pattern, CAM, BLACK, INV_RANGE)
        assert got == dm.power_mean(xyz[1, ::2, ::2], factor)
        assert np.float32(2.0 ** math.log2(0.18 / max(got, 1e-9))) == _host_gain(m, pattern, EXIF)


def _prep_before(path, frame_height):
    """``_try_load_mosaic_impl``'s answer before K15, for an eligible
    file: the host estimate on ``raw.data`` and the aspect crop on the
    host, the mosaic left for the render to upload."""
    raw = dng.read_raw(path)
    inv_range = 1.0 / max(raw.white_level - raw.black_level, 1.0)
    norm = np.asarray([raw.black_level, inv_range], np.float32)
    cam = np.linalg.inv(np.asarray(raw.color_matrix, np.float64)).astype(np.float32)
    xyz = dm.half_size_xyz(raw.data, raw.cfa_pattern, cam, float(raw.black_level), float(inv_range))
    gain = np.float32(2.0 ** calc_exposure(xyz, metadata=raw.metadata))
    mosaic, crop = tproc._mosaic_aspect_crop(np.ascontiguousarray(raw.data).astype(np.uint16), 36.0 / frame_height)
    return (mosaic, norm, raw.cfa_pattern, cam, gain, crop), raw


@pytest.mark.parametrize("frame_height", [24.0, 23.9])
def test_fused_process_on_the_cpu_is_unchanged(tmp_path, monkeypatch, frame_height):
    path = str(tmp_path / "f.dng")
    dng.write_dng(path, _codes(96, 144, 5), black_level=512, white_level=24000)
    kw = dict(STOCKS, seed=4, half_size=False, max_scale=None, frame_height=frame_height, cache=False)
    proc = Processor(device="cpu")
    (mosaic, _, _, _, gain, crop), _ = proc._try_load_mosaic_impl(path, kw)
    before = _prep_before(path, frame_height)
    assert isinstance(mosaic, torch.Tensor) and mosaic.is_contiguous()
    np.testing.assert_array_equal(mosaic.numpy(), before[0][0])
    assert gain == before[0][4] and crop == before[0][5]
    assert (crop is None) == (frame_height == 24.0)
    out = proc.process(path, **kw)
    old = Processor(device="cpu")
    monkeypatch.setattr(old, "_try_load_mosaic_impl", lambda src, load_kw: before)
    np.testing.assert_array_equal(out, old.process(path, **kw))


@pytest.mark.parametrize("as_float", [False, True], ids=["u16-strip", "integral-float32"])
def test_prep_checks_only_float_codes(tmp_path, as_float):
    path = str(tmp_path / "f.dng")
    dng.write_dng(path, _codes(96, 144, 5), black_level=512, white_level=24000)
    kw = dict(STOCKS, seed=4, half_size=False, max_scale=None, cache=False)
    src = path
    if as_float:  # the RAF and RW2 readers' integral float32 codes
        raw = dng.read_raw(path)
        src = dataclasses.replace(raw, data=raw.data.astype(np.float32))
    proc = Processor(device="cpu")
    before = trace.COUNTS.get("prep.integral_check", 0)
    (mosaic, *_), _ = proc._try_load_mosaic_impl(src, kw)
    assert trace.COUNTS.get("prep.integral_check", 0) - before == int(as_float)
    assert mosaic.dtype == torch.uint16
    np.testing.assert_array_equal(mosaic.numpy(), _prep_before(path, 24.0)[0][0])


@pytest.mark.parametrize("aspect", ASPECTS)
def test_aspect_crop_of_a_tensor_matches_the_host_crop(aspect):
    for h, w in SHAPES:
        if h * w >= 10**5:
            continue
        m = np.arange(h * w, dtype=np.uint16).reshape(h, w)
        got, want = tproc._mosaic_aspect_crop(torch.from_numpy(m), aspect), tproc._mosaic_aspect_crop(m, aspect)
        assert isinstance(got[0], torch.Tensor) and got[0].is_contiguous()
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        assert got[1] == want[1]
