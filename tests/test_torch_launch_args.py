"""What the K2/K4, K10, K13 and K14 wrappers hand their kernels, on the CPU.

K2 and K4 take their taps by value (``ops/sep_rank.py::pack``, the
``r2f::sep::Ranks`` struct of ``csrc/sep_rank.cuh``), packed once per
distinct stack and cached by content; a stack above the struct's capacity
goes to a device buffer uploaded once. K14 takes its shared ranks by value
too (``ops/halation.py::pack``, ``r2f::hal::Stack`` of ``csrc/halation.cu``),
padded to the tap length of one of its kernels. K13 takes its x f phase
table by value (``ops/pyramid.py::phases``); K10 picks its 16-byte path by
shape and alignment (``ops/pyramid.py::box_vec_path``). No card is needed:
these are the host halves of the launches."""

import ctypes
import os
import re
import sys
import threading

import numpy as np
import pytest

from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.ops import halation, pyramid, sep_rank
from raw2film_tpu_torch.ops.conv import gaussian_kernel1d

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "raw2film_tpu_torch", "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constant(name: str, source: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _source(source)).group(1))


def _taps(p: sep_rank.Packed) -> np.ndarray:
    return np.ctypeslib.as_array(p.args.taps)[: p.taps.size]


def _c_signatures() -> dict:
    """name -> ctypes argtypes of every ``R2F_API int`` entry point in
    csrc/*.cu, from its C parameter list: pointers as c_void_p, ``int`` as
    c_int, ``unsigned int`` as c_uint, ``float`` as c_float."""
    out = {}
    for name in sorted(os.listdir(CSRC)):
        if not name.endswith(".cu"):
            continue
        for fn, params in re.findall(r"R2F_API int (\w+)\(([^)]*)\)", _source(name)):
            types = []
            for p in params.split(","):
                p = " ".join(p.split())
                if "*" in p:
                    types.append(ctypes.c_void_p)
                elif p.startswith("unsigned int "):
                    types.append(ctypes.c_uint)
                elif p.startswith("int "):
                    types.append(ctypes.c_int)
                elif p.startswith("float "):
                    types.append(ctypes.c_float)
                else:
                    raise AssertionError(f"{fn}: parameter {p!r} has no ctypes rule")
            out[fn] = tuple(types)
    return out


def test_structs_match_the_kernel_sources():
    assert sep_rank.MAX_TAPS == _constant("MAX_TAPS", "sep_rank.cuh")
    assert sep_rank.MAX_C == _constant("MAX_C", "sep_rank.cuh")
    assert ctypes.sizeof(sep_rank.Ranks) == 44 + 4 * sep_rank.MAX_TAPS
    assert sep_rank.grain_ops.MAX_TAPS == _constant("MAX_TAPS", "grain.cuh")
    assert ctypes.sizeof(sep_rank.GrainArgs) == 12 + 4 * sep_rank.grain_ops.MAX_TAPS
    assert pyramid.UP_MAX_F == _constant("UP_MAX_F", "pyramid.cu")
    assert ctypes.sizeof(pyramid.Phases) == 4 + 12 * pyramid.UP_MAX_F
    # K14's launch struct and its entry point
    assert halation.MAX_TAPS == _constant("MAX_TAPS", "halation.cu")
    assert (halation.K_MIN, halation.K_MAX) == (_constant("K_MIN", "halation.cu"), _constant("K_MAX", "halation.cu"))
    assert "sizeof(Stack) == 24 + 4 * MAX_TAPS" in _source("halation.cu")
    assert ctypes.sizeof(halation.Stack) == 24 + 4 * halation.MAX_TAPS
    assert [f for f, _ in halation.Stack._fields_] == ["C", "H", "W", "W4", "R", "K", "taps"]
    want = (ctypes.c_void_p,) * 7  # img, rows_up, out, stack, factors, develop, stream
    assert _c_signatures()["r2f_halation"] == kb._SIGNATURES["r2f_halation"] == want


@pytest.mark.parametrize("name", sorted(kb._SIGNATURES))
def test_argtypes_match_the_c_entry_points(name):
    """ctypes passes each argument as the C function declares it (a pointer
    given as c_int would be cut to 32 bits)."""
    assert kb._SIGNATURES[name] == _c_signatures()[name]


def test_halation_packed_layout():
    """Each rank's column taps then its row taps, both zero-padded
    symmetrically to the kernel's K (here the longer, 7 -> 25, the
    shortest kernel); the shape and W4 = ceil(W / 4) beside them."""
    rng = np.random.default_rng(5)
    u = rng.normal(size=(3, 5)).astype(np.float32)
    v = rng.normal(size=(3, 7)).astype(np.float32)
    p = halation.pack(u, v, 3, 37, 70)
    k = halation.K_MIN
    want = np.concatenate([np.pad(u, ((0, 0), ((k - 5) // 2,) * 2)), np.pad(v, ((0, 0), ((k - 7) // 2,) * 2))], 1)
    np.testing.assert_array_equal(p.taps, want)
    np.testing.assert_array_equal(np.ctypeslib.as_array(p.args.taps)[: want.size], want.ravel())
    assert (p.args.C, p.args.H, p.args.W, p.args.W4, p.args.R, p.args.K) == (3, 37, 70, 18, 3, k)
    assert halation.pack(u.copy(), v.copy(), 3, 37, 70) is p  # cached by content and shape
    assert halation.pack(u, v, 3, 37, 72) is not p
    us, vs, _ = halation._full_res_ranks(57.0)  # the 45 MP stack: 4 ranks x 27 taps, unpadded
    p27 = halation.pack(us, vs, 3, 5472, 8208)
    assert (p27.args.R, p27.args.K, p27.args.W4) == (4, 27, 2052)
    np.testing.assert_array_equal(p27.taps, np.concatenate([np.float32(us), np.float32(vs)], 1))


def test_halation_stacks_pack_by_value():
    """Every stack _full_res_ranks gives where K14 runs (the /4 pyramid
    alone: halation sizes 41.6-163.2) fits the struct: at most 490 floats,
    a tap length one of the kernels takes, never padded."""
    lengths, most = set(), 0
    for size in np.arange(40.0, 163.95, 0.1):
        us, vs, by_factor = halation._full_res_ranks(float(round(size, 1)))
        if list(by_factor) != [halation.PYR_F]:
            continue
        p = halation.pack(us, vs, 3, 64, 96)
        assert p.taps.shape == (len(us), 2 * len(us[0]))  # no padding
        assert p.args.K % 2 == 1 and halation.K_MIN <= p.args.K <= halation.K_MAX
        lengths.add(p.args.K)
        most = max(most, p.taps.size)
    assert most == 490 <= halation.MAX_TAPS
    assert lengths == set(range(25, 50, 2))


def test_halation_pack_refuses():
    long = np.ones((1, halation.K_MAX + 2), np.float32)
    with pytest.raises(ValueError):
        halation.pack(long, long, 3, 40, 40)  # above the longest kernel
    many = np.ones((6, halation.K_MAX), np.float32)
    with pytest.raises(ValueError):
        halation.pack(many, many, 3, 40, 40)  # 588 floats, above the struct
    with pytest.raises(ValueError):
        halation.pack(np.ones((3, 1, 27), np.float32), np.ones((3, 1, 27), np.float32), 3, 40, 40)  # per channel


@pytest.mark.parametrize(
    "f,w,offset,vec",
    [(4, 8208, 0, True), (8, 8208, 0, True), (12, 96, 0, False), (4, 8207, 0, False), (4, 8208, 4, False),
     (4, 8208, 16, True), (3, 8208, 0, False), (2, 64, 0, False), (1, 64, 0, False)],
)
def test_box_downsample_path(f, w, offset, vec):
    """K10's 16-byte path takes f = 4 or 8, W a multiple of 4 and a 16-byte
    aligned input; every other shape goes to the one-thread-per-output
    kernel."""
    assert pyramid.box_vec_path(f, w, 0x7F0000000000 + offset) is vec


def _stacks():
    rng = np.random.default_rng(3)
    shared = rng.normal(size=(2, 2, 7)).astype(np.float32)
    per_channel = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    padded = per_channel.copy()
    padded[0, 1, 2:] = 0.0  # channel 1 runs 2 ranks
    padded[1, 2, 1:] = 0.0  # channel 2 runs 1
    padded[1, 0, 0] = 0.0  # channel 0: rank 0 zero, rank 3 live: runs 4
    g3, g7 = gaussian_kernel1d(0.8, 3.0), gaussian_kernel1d(2.0, 2.0)
    ragged = ([g3 * 0.3, g7 * 0.7], [g3, g7])
    ragged_u = np.stack([np.pad(g3 * 0.3, 2), g7 * 0.7])
    ragged_v = np.stack([np.pad(g3, 2), g7])
    return {
        # (u, v, channels, the (Cb, R, KV + KH) layout, nrank)
        "shared": (shared[0], shared[1], 3, np.concatenate([shared[0], shared[1]], 1)[None], [2]),
        "per-channel": (per_channel[0], per_channel[1], 3,
                        np.concatenate([per_channel[0], per_channel[1]], 2), [4, 4, 4]),
        "zero-padded": (padded[0], padded[1], 3, np.concatenate([padded[0], padded[1]], 2), [4, 2, 1]),
        "ragged": (*ragged, 2, np.concatenate([ragged_u, ragged_v], 1)[None], [2]),
    }


@pytest.mark.parametrize("name", list(_stacks()))
def test_packed_layout(name):
    """The struct holds the taps as the kernel reads them (per channel, per
    rank, column taps then row taps) and the ranks each channel runs."""
    u, v, c, want, nrank = _stacks()[name]
    p = sep_rank.pack(u, v, c, 40, 50)
    assert p.by_value
    np.testing.assert_array_equal(_taps(p), want.astype(np.float32).ravel())
    np.testing.assert_array_equal(p.taps, want)
    assert list(p.args.nrank[: len(nrank)]) == nrank == p.nrank.tolist()
    assert p.args.per_channel == int(want.shape[0] > 1)
    assert (p.args.C, p.args.H, p.args.W) == (c, 40, 50)
    assert (p.args.R, p.args.KV, p.args.KH) == (want.shape[1], want.shape[2] // 2, want.shape[2] // 2)


def test_equal_stacks_hit_the_cache():
    """The burn blur rebuilds its Gaussian on every call: equal taps built
    anew find the packed stack; other taps, or another image shape, do not."""
    k1 = gaussian_kernel1d(3.0, truncate=2.0)
    first = sep_rank.pack(k1[None], k1[None], 1, 49, 74)
    again = gaussian_kernel1d(3.0, truncate=2.0)
    assert sep_rank.pack(again[None], again[None], 1, 49, 74) is first
    assert sep_rank.pack([tuple(map(float, k1))], [tuple(map(float, k1))], 1, 49, 74).taps.tobytes() == first.taps.tobytes()
    other = again.copy()
    other[3] = np.nextafter(other[3], np.float32(1.0))
    changed = sep_rank.pack(other[None], again[None], 1, 49, 74)
    assert changed is not first
    assert _taps(changed)[3] == other[3] != _taps(first)[3]
    assert sep_rank.pack(again[None], again[None], 1, 49, 80) is not first


def test_packed_narrow_flag():
    """The cached flag is tpu_declines of the image shape it was packed for."""
    u = np.full((1, 2, 23), 0.01, np.float32)
    for h, w in ((540, 360), (5472, 8208), (49, 74), (3000, 600)):
        assert sep_rank.pack(u, u, 3, h, w).narrow == sep_rank.tpu_declines(h, w, 11)


def test_stack_above_capacity_takes_the_device_buffer():
    """9 ranks x (121 + 121) taps = 2178 floats: above the struct, so the
    wrapper reads a device buffer, uploaded once per stack and device."""
    rng = np.random.default_rng(9)
    u = (rng.normal(size=(9, 121)) * 0.02).astype(np.float32)
    v = (rng.normal(size=(9, 121)) * 0.02).astype(np.float32)
    assert u.size + v.size > sep_rank.MAX_TAPS
    p = sep_rank.pack(u, v, 3, 60, 70)
    assert not p.by_value
    buf = sep_rank.device_taps(p, "cpu")
    np.testing.assert_array_equal(buf.numpy(), np.concatenate([u, v], 1)[None])
    assert sep_rank.device_taps(p, "cpu") is buf
    rebuilt = sep_rank.pack(u.copy(), v.copy(), 3, 200, 90)  # another shape, the same taps
    assert rebuilt is not p and sep_rank.device_taps(rebuilt, "cpu") is buf
    small = sep_rank.pack(u[:4], v[:4], 3, 60, 70)
    assert small.by_value


def test_pack_refuses():
    u = np.ones((3, 1, 3), np.float32)
    with pytest.raises(ValueError):
        sep_rank.pack(u, u, 2, 10, 10)  # 3 channels of taps, 2 of image
    u5 = np.ones((5, 1, 3), np.float32)
    with pytest.raises(ValueError):
        sep_rank.pack(u5, u5, 5, 10, 10)  # above MAX_C per-channel stacks


def test_pack_cache_under_threads():
    """Threads packing overlapping stacks (the preview worker beside the
    caller) each get their own taps back, and the cache stays bounded."""
    rng = np.random.default_rng(11)
    stacks = [(rng.normal(size=(2, 5)).astype(np.float32),) * 2 for _ in range(3 * sep_rank.CACHE_SIZE)]
    errors = []

    def work(offset):
        try:
            for i in range(len(stacks)):
                u, v = stacks[(i + offset) % len(stacks)]
                p = sep_rank.pack(u.copy(), v.copy(), 3, 20, 30)
                if not np.array_equal(p.taps[0], np.concatenate([u, v], 1)):
                    errors.append(i)
        except Exception as exc:  # noqa: BLE001 - reported through the assert below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k * 17,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(sep_rank._packed) <= sep_rank.CACHE_SIZE


@pytest.mark.parametrize("f", [1, 2, 3, 4, 8, 16])
def test_phase_table_gives_lerp_taps(f):
    """Output o = q f + m takes input q + base[m] and the next, clamped to
    the axis, with the phase's weights folded where the clamp merges them:
    the kernel's rule gives lerp_taps exactly, cropped or whole."""
    p = pyramid.phases(f)
    assert p.f == f
    base = np.array(p.base[:f])
    w0t, w1t = (np.ctypeslib.as_array(a)[:f] for a in (p.w0, p.w1))
    for n_in, n_out in ((37, 37 * f), (37, 37 * f - 5), (1, f), (5, 5 * f)):
        o = np.arange(n_out)
        q, m = o // f, o % f
        i0 = np.clip(q + base[m], 0, n_in - 1)
        i1 = np.clip(q + base[m] + 1, 0, n_in - 1)
        w0, w1 = w0t[m].copy(), w1t[m].copy()
        same = i0 == i1
        w0[same] = w0[same] + w1[same]
        w1[same] = 0.0
        for got, want in zip((i0, i1, w0, w1), pyramid.lerp_taps(n_in, f, n_out)):
            np.testing.assert_array_equal(got, want)


def test_phase_table_refuses_large_factors():
    with pytest.raises(ValueError):
        pyramid.phases(pyramid.UP_MAX_F + 1)
