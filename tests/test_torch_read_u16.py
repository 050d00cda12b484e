"""``io/dng.py::read_raw`` keeps an uncompressed 16-bit strip's codes as
uint16 in host byte order, against the JAX package's reader (which holds
them as float32): the same values and the same black level, white level,
CFA pattern and colour matrix, for one little-endian strip (a view on the
file's bytes), one big-endian strip (swapped into host order) and several
strips (joined once). Packed 12- and 14-bit strips and lossless JPEG still
come back as float32, equal to the JAX reader's."""

import sys

import numpy as np
import pytest

import raw2film_tpu  # noqa: F401  (the real package, imported first)
import raw_fixtures as fx
from raw2film_tpu.io import dng as jdng
from raw2film_tpu_torch.io import dng as tdng

BLACK, WHITE = 512, 16383


def _mosaic(h, w, hi=WHITE, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi + 1, (h, w)).astype(np.uint16)


def _write_strips(path, mosaic, endian, n_strips):
    """An uncompressed 16-bit CFA DNG in ``endian`` byte order, its rows in
    ``n_strips`` strips."""
    h, w = mosaic.shape
    rows = -(-h // n_strips)
    blobs = [mosaic[y : y + rows].astype(endian + "u2").tobytes() for y in range(0, h, rows)]
    ifd = fx._Ifd()
    for tag, typ, values in (
        (254, 4, [0]), (256, 4, [w]), (257, 4, [h]), (258, 3, [16]), (259, 3, [1]),
        (262, 3, [32803]), (273, 4, ("blobs", list(range(len(blobs))))), (277, 3, [1]),
        (278, 4, [rows]), (279, 4, [len(b) for b in blobs]), (33421, 3, [2, 2]),
        (33422, 1, [1, 0, 2, 1]), (50714, 3, [BLACK]), (50717, 3, [WHITE]),
    ):
        ifd.add(tag, typ, values)
    with open(path, "wb") as f:
        f.write(fx._serialize([ifd], blobs, endian=endian))


def _root(a):
    while isinstance(a, np.ndarray) and a.base is not None:
        a = a.base
    return a


def _same_fields(got, want):
    """Every field but ``data`` equal to the JAX reader's."""
    assert got.cfa_pattern == want.cfa_pattern
    assert got.black_level == want.black_level and got.white_level == want.white_level
    for name in ("color_matrix", "as_shot_neutral"):
        a, b = getattr(want, name), getattr(got, name)
        assert (a is None and b is None) or np.array_equal(a, b), name
    assert got.metadata == want.metadata


STRIPS = [("<", 1), (">", 1), ("<", 3), (">", 3)]


@pytest.mark.parametrize("endian,n_strips", STRIPS, ids=[f"{'le' if e == '<' else 'be'}-{n}" for e, n in STRIPS])
def test_16bit_strip_is_uint16_in_host_order(tmp_path, endian, n_strips):
    path = str(tmp_path / "f.dng")
    mosaic = _mosaic(40, 62)
    _write_strips(path, mosaic, endian, n_strips)
    want, got = jdng.read_raw(path), tdng.read_raw(path)
    assert want.data.dtype == np.float32
    assert got.data.dtype == np.uint16 and got.data.dtype.isnative
    assert got.data.shape == mosaic.shape and got.data.flags.c_contiguous
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.data, mosaic)
    # One strip in the host's order is read in place: a view on the file.
    in_place = n_strips == 1 and (endian == "<") == (sys.byteorder == "little")
    assert isinstance(_root(got.data), memoryview) == in_place
    _same_fields(got, want)
    assert (got.cfa_pattern, got.black_level, got.white_level) == ("GRBG", BLACK, WHITE)


FLOAT_FIXTURES = {
    "nef-12bit-packed": lambda p: fx.write_nef(p, _mosaic(32, 48, hi=4095), bits=12),
    "nef-14bit-packed": lambda p: fx.write_nef(p, _mosaic(32, 48), bits=14),
    "dng-ljpeg-tiled": lambda p: fx.write_dng_tiled(p, _mosaic(64, 96)),
}


@pytest.mark.parametrize("name", list(FLOAT_FIXTURES))
def test_other_sample_formats_stay_float32(tmp_path, name):
    path = str(tmp_path / f"f.{name.split('-')[0]}")
    FLOAT_FIXTURES[name](path)
    want, got = jdng.read_raw(path), tdng.read_raw(path)
    assert got.data.dtype == want.data.dtype == np.float32
    np.testing.assert_array_equal(got.data, want.data)
    _same_fields(got, want)
