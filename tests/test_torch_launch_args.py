"""What the K2/K4, K3, K10, K13, K14 and K16 wrappers hand their kernels, on the CPU.

K2 and K4 take their taps by value (``ops/sep_rank.py::pack``, the
``r2f::sep::Ranks`` struct of ``csrc/sep_rank.cuh``), packed once per
distinct stack and cached by content, every rank zero-padded about its
centre to chunks of ``CK`` taps with its own chunk counts and window
offsets; a stack above the struct's capacity goes to a device buffer
uploaded once. K3 takes the burn's matrices from a device cache
(``kernels/cache.py::on_device``) and picks its 16-byte path by shape and
alignment (``ops/print_encode.py::vector_path``). K14 takes its shared ranks by value
too (``ops/halation.py::pack``, ``r2f::hal::Stack`` of ``csrc/halation.cu``),
padded to the tap length of one of its kernels. K13 takes its x f phase
table by value (``ops/pyramid.py::phases``); K10 picks its 16-byte path by
shape and alignment (``ops/pyramid.py::box_vec_path``). K16 takes the
development's parameters by value from the bundle's host copy
(``develop_host``). No card is needed: these are the host halves of the
launches."""

import ctypes
import os
import re
import sys
import threading

import numpy as np
import pytest

import torch

from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.kernels import cache
from raw2film_tpu_torch.ops import burn, chroma_nr, conv, develop, halation, mtf, print_encode, pyramid, sep_conv, sep_rank
from raw2film_tpu_torch.ops.conv import gaussian_kernel1d

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "raw2film_tpu_torch", "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constant(name: str, source: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _source(source)).group(1))


def _taps(p: sep_rank.Packed) -> np.ndarray:
    return np.ctypeslib.as_array(p.args.taps)[: p.taps.size]


def _ranks_of(p: sep_rank.Packed) -> list:
    return [(g.nv, g.ov, g.nh, g.oh) for g in p.args.rank[: p.args.R]]


def _centred(p: sep_rank.Packed) -> tuple[np.ndarray, np.ndarray]:
    """The packed stack read back as centred (Cb, R, k) column and row
    stacks: each rank's padded taps placed by its window offsets."""
    a, ck = p.args, sep_rank.CK
    top, bottom = a.top, a.EH - sep_rank.TH - a.top
    left, right = a.left, a.EW - sep_rank.TW - a.left
    rv, rh = max(top, bottom), max(left, right)
    cb = p.taps.shape[0]
    u = np.zeros((cb, a.R, 2 * rv + 1), np.float32)
    v = np.zeros((cb, a.R, 2 * rh + 1), np.float32)
    off = 0
    for r, (nv, ov, nh, oh) in enumerate(_ranks_of(p)):
        u[:, r, rv + ov - top: rv + ov - top + nv * ck] = p.taps[:, off: off + nv * ck]
        off += nv * ck
        v[:, r, rh + oh - left: rh + oh - left + nh * ck] = p.taps[:, off: off + nh * ck]
        off += nh * ck
    assert off == a.stride == p.taps.shape[1]
    return u, v


def _widen(t: np.ndarray, k: int) -> np.ndarray:
    """A (..., n) odd-length tap array zero-padded symmetrically to k."""
    return np.pad(t, [(0, 0)] * (t.ndim - 1) + [((k - t.shape[-1]) // 2,) * 2])


def _same_taps(a: np.ndarray, b: np.ndarray) -> None:
    k = max(a.shape[-1], b.shape[-1])
    np.testing.assert_array_equal(_widen(a, k), _widen(b, k))


def _emulate(p: sep_rank.Packed, img: np.ndarray) -> np.ndarray:
    """What the kernel computes from the packed launch, in float64: the
    reflect-101 window of the plane (``top`` rows above, ``left`` columns
    left of the output), then per rank the column pass at window rows ov + y
    + q and the row pass at window columns oh + x + q, over its padded
    chunks."""
    a, ck = p.args, sep_rank.CK
    c, h, w = img.shape
    out = np.zeros((c, h, w))
    for ch in range(c):
        cb = ch if a.per_channel else 0
        win = np.pad(img[ch].astype(np.float64),
                     ((a.top, a.EH - sep_rank.TH - a.top), (a.left, a.EW - sep_rank.TW - a.left)),
                     mode="reflect")
        off = 0
        for nv, ov, nh, oh in _ranks_of(p)[: a.nrank[cb]]:
            tu = p.taps[cb, off: off + nv * ck]
            tv = p.taps[cb, off + nv * ck: off + (nv + nh) * ck]
            col = sum(tu[q] * win[ov + q: ov + q + h] for q in range(nv * ck))
            out[ch] += sum(tv[q] * col[:, oh + q: oh + q + w] for q in range(nh * ck))
            off += (nv + nh) * ck
    return out


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
    for name in ("MAX_TAPS", "MAX_C", "MAX_R", "SMALL_TAPS", "CK", "TH", "TW"):
        assert getattr(sep_rank, name) == _constant(name, "sep_rank.cuh"), name
    assert "sizeof(Ranks) == 312 + 4 * MAX_TAPS" in _source("sep_rank.cuh")
    assert ctypes.sizeof(sep_rank.Ranks) == 312 + 4 * sep_rank.MAX_TAPS
    assert ctypes.sizeof(sep_rank.Rank) == 16
    fields = re.search(r"struct RanksOf \{(.*?)\};", _source("sep_rank.cuh"), re.S).group(1)
    names = re.findall(r"(\w+)(?:\[\w+\])?[,;]", fields)
    assert names == [f for f, _ in sep_rank.Ranks._fields_]
    assert re.search(r"struct Rank \{\s*int nv, ov, nh, oh;", _source("sep_rank.cuh"))
    assert sep_rank.grain_ops.MAX_TAPS == _constant("MAX_TAPS", "grain.cuh")
    # K7 / K8's compiled tap counts: the list the wrappers name paths by, and
    # the dispatch of csrc/grain.cu
    listed = re.search(r"// COMPILED_TAPS: ([\d ]+)\n", _source("grain.cu")).group(1).split()
    dispatched = re.findall(r"if \(g\.ntaps == (\d+)\)\n\s+return vec \? launch_taps<\1,", _source("grain.cu"))
    assert tuple(map(int, listed)) == tuple(map(int, dispatched)) == sep_rank.grain_ops.COMPILED_TAPS
    assert re.search(r"if \(g\.ntaps == 1\) \{\n.*grain_white_kernel", _source("grain.cu"), re.S)
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
    wide = np.zeros((2, 17), np.float32)  # 17 taps wide, 9 of them live
    wide[:, 4:13] = rng.normal(size=(2, 9))
    return {
        # (u, v, channels, nrank, (column, row) chunks per rank)
        "shared": (shared[0], shared[1], 3, [2], [(1, 1)] * 2),
        "per-channel": (per_channel[0], per_channel[1], 3, [4, 4, 4], [(1, 1)] * 4),
        "zero-padded": (padded[0], padded[1], 3, [4, 2, 1], [(1, 1)] * 4),
        "ragged": (*ragged, 2, [2], [(1, 1), (2, 2)]),
        "zero-ends": (wide, shared[1], 1, [2], [(2, 1)] * 2),
    }


@pytest.mark.parametrize("name", list(_stacks()))
def test_packed_layout(name):
    """The struct holds the taps as the kernel reads them (per channel, per
    rank, its chunk-padded column taps then row taps, each at its window
    offset), the ranks each channel runs, and the chunks each rank runs:
    ceil(true length / CK), its zero ends not counted."""
    u, v, c, nrank, chunks = _stacks()[name]
    p = sep_rank.pack(u, v, c, 40, 50)
    assert p.by_value
    np.testing.assert_array_equal(_taps(p), p.taps.ravel())
    u3, v3 = sep_rank.stack_taps(u, v)
    cu, cv = _centred(p)
    _same_taps(cu, u3)
    _same_taps(cv, v3)
    assert list(p.args.nrank[: len(nrank)]) == nrank == p.nrank.tolist()
    assert p.args.per_channel == int(u3.shape[0] > 1)
    assert (p.args.C, p.args.H, p.args.W, p.args.R) == (c, 40, 50, u3.shape[1])
    assert [(nv, nh) for nv, _, nh, _ in _ranks_of(p)] == chunks


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
    i = 3 + (sep_rank.CK * 2 - len(k1)) // 2  # 13 taps run 16, one zero before them
    assert _taps(changed)[i] == other[3] != _taps(first)[i]
    assert sep_rank.pack(again[None], again[None], 1, 49, 80) is not first


def test_packed_narrow_flag():
    """The cached flag is tpu_declines of the image shape it was packed for."""
    u = np.full((1, 2, 23), 0.01, np.float32)
    for h, w in ((540, 360), (5472, 8208), (49, 74), (3000, 600)):
        assert sep_rank.pack(u, u, 3, h, w).narrow == sep_rank.tpu_declines(h, w, 11)


def test_stack_above_capacity_takes_the_device_buffer(fake_launch, monkeypatch):
    """9 ranks x (121 + 121) taps, 128 + 128 when padded = 2304 floats:
    above the struct, so the wrapper reads a device buffer of the packed
    layout, uploaded once per stack and device."""
    made = []
    real = torch.tensor
    monkeypatch.setattr(torch, "tensor", lambda *a, **k: (made.append(a), real(*a, **k))[1])
    rng = np.random.default_rng(9)
    u = (rng.normal(size=(9, 121)) * 0.02).astype(np.float32)
    v = (rng.normal(size=(9, 121)) * 0.02).astype(np.float32)
    p = sep_rank.pack(u, v, 3, 60, 70)
    assert p.taps.size == 9 * 256 > sep_rank.MAX_TAPS and not p.by_value
    for _ in range(3):
        sep_rank.fused_sep_rank(torch.zeros(3, 60, 70), u, v)
    buf = cache.on_device(p.key, None, "cpu")  # no build: the launches uploaded it
    assert len(made) == 1 and [a[3] for _, a in fake_launch.calls] == [buf.data_ptr()] * 3
    np.testing.assert_array_equal(buf.numpy(), p.taps)
    cu, cv = _centred(p)
    _same_taps(cu, u[None])
    _same_taps(cv, v[None])
    rebuilt = sep_rank.pack(u.copy(), v.copy(), 3, 200, 90)  # another shape, the same taps
    assert rebuilt is not p and rebuilt.key == p.key
    sep_rank.fused_sep_rank(torch.zeros(3, 200, 90), u.copy(), v.copy())
    assert len(made) == 1 and fake_launch.calls[-1][1][3] == buf.data_ptr()
    small = sep_rank.pack(u[:4], v[:4], 3, 60, 70)
    assert small.by_value


_BUNDLE = {}


def _mtf_key():
    if not _BUNDLE:
        from raw2film_tpu_torch import load_film_bundle

        _BUNDLE["cfg"] = load_film_bundle(h=540, w=360, device="cpu", grain=2, sharpness=True)[1]
    return _BUNDLE["cfg"].mtf_key


def _port_stack(name: str):
    """(u, v, channels) of a stack the port sends: the MTF at a scale in
    px/mm, the glow's dense and SVD tiers and the /4 small blur at a
    halation size, chroma NR at a strength, the burn's Gaussian."""
    kind, _, arg = name.partition("-")
    if kind == "mtf":
        return (*mtf.mtf_taps(_mtf_key(), float(arg)), 3)
    if kind == "glow":
        k = halation.exponential_blur_kernel(float(arg)).astype(np.float32)
        return (*conv.svd_separable(k, tol=1e-4, max_rank=6 if float(arg) <= 12.0 else 8), 3)
    if kind == "smallblur":
        return (*halation.pyramid_taps(4, halation._full_res_ranks(float(arg))[2][4]), 3)
    if kind == "chromanr":
        size = int(arg) * 2 + 1
        k = chroma_nr.cv_gaussian_kernel1d(size, 0.3 * ((size - 1) * 0.5 - 1.0) + 0.8)[None]
        return k, k, 2
    k = gaussian_kernel1d(3.0, truncate=2.0)[None]
    return k, k, 1


PORT_STACKS = ["mtf-15", "mtf-30", "mtf-57", "mtf-114", "mtf-228", "mtf-400", "glow-3", "glow-10",
               "glow-13", "glow-25", "glow-40", "smallblur-57", "smallblur-41.7", "smallblur-100",
               "chromanr-1", "chromanr-3", "chromanr-10", "burn"]


@pytest.mark.parametrize("name", PORT_STACKS)
def test_port_stacks_chunk_layout(name):
    """Every stack the port sends packs by value, each rank in
    ceil(true length / CK) chunks (less than one chunk of padding), inside
    the window the kernel stages (what r2f_sep_rank checks before a launch);
    read back, the padded taps are the stack; and the kernel's arithmetic on
    the packed launch, emulated, gives the plain version."""
    u, v, c = _port_stack(name)
    p = sep_rank.pack(u, v, c, 37, 45)
    a, ck = p.args, sep_rank.CK
    assert p.by_value and p.taps.size <= sep_rank.MAX_TAPS
    u3, v3 = sep_rank.stack_taps(u, v)
    if isinstance(u, list):
        true = [(len(a_), len(b_)) for a_, b_ in zip(u, v)]
    else:
        span = lambda t: [int(2 * np.abs(np.nonzero(np.any(t[:, r] != 0, 0))[0] - t.shape[-1] // 2).max() + 1)  # noqa: E731
                          for r in range(t.shape[1])]
        true = list(zip(span(u3), span(v3)))
    assert [(nv, nh) for nv, _, nh, _ in _ranks_of(p)] == [(-(-lu // ck), -(-lv // ck)) for lu, lv in true]
    total = 0
    for nv, ov, nh, oh in _ranks_of(p):
        assert ov >= 0 and ov + sep_rank.TH + nv * ck - 1 <= a.EH
        assert oh >= 0 and oh + sep_rank.TW + nh * ck - 1 <= a.EW
        total += (nv + nh) * ck
    assert total == a.stride and 0 < a.stride * p.taps.shape[0] == p.taps.size
    cu, cv = _centred(p)
    _same_taps(cu, u3)
    _same_taps(cv, v3)
    img = np.random.default_rng(4).uniform(0.0, 3.0, (c, 37, 45)).astype(np.float32)
    want = sep_rank.fused_sep_rank_plain(torch.from_numpy(img), u, v).numpy()
    np.testing.assert_allclose(_emulate(p, img), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["mtf-57", "glow-25", "smallblur-57", "chromanr-3", "zero-ends"])
def test_plain_unchanged_by_padding(name):
    """The plain version of the stack as the kernel runs it (every rank
    padded to its chunks, at its window offset) equals the plain version of
    the stack as given, bit for bit: the padding adds exact zeros."""
    u, v, c = _port_stack(name) if name != "zero-ends" else _stacks()[name][:3]
    p = sep_rank.pack(u, v, c, 37, 45)
    img = torch.from_numpy(np.random.default_rng(6).uniform(0.0, 3.0, (c, 37, 45)).astype(np.float32))
    cu, cv = _centred(p)
    if cu.shape[0] == 1:
        cu, cv = cu[0], cv[0]
    np.testing.assert_array_equal(sep_rank.fused_sep_rank_plain(img, cu, cv).numpy(),
                                  sep_rank.fused_sep_rank_plain(img, u, v).numpy())


def test_small_blur_ranks_run_their_own_length():
    """The 45 MP /4 small blur: ranks of 15 and 27 taps run 16 and 32, not
    both the longest; the MTF's 23 run 24."""
    u, v, _ = _port_stack("smallblur-57")
    assert [len(t) for t in u] == [15, 27]
    assert [nv for nv, _, _, _ in _ranks_of(sep_rank.pack(u, v, 3, 1368, 2052))] == [2, 4]
    u3, v3, _ = _port_stack("mtf-228")
    assert u3.shape == (3, 4, 23)
    assert _ranks_of(sep_rank.pack(u3, v3, 3, 5472, 8208))[0][::2] == (3, 3)


@pytest.mark.parametrize("name", ["mtf-15", "glow-3", "burn"])
def test_k4_stacks_launch_small(name):
    """K4's stacks (the preview's MTF at 15 px/mm, its glow's dense tier,
    the burn's Gaussian) launch with the struct cut to SMALL_TAPS."""
    u, v, c = _port_stack(name)
    assert sep_rank.pack(u, v, c, 540, 360).taps.size <= sep_rank.SMALL_TAPS


def test_pack_refuses():
    u = np.ones((3, 1, 3), np.float32)
    with pytest.raises(ValueError):
        sep_rank.pack(u, u, 2, 10, 10)  # 3 channels of taps, 2 of image
    u5 = np.ones((5, 1, 3), np.float32)
    with pytest.raises(ValueError):
        sep_rank.pack(u5, u5, 5, 10, 10)  # above MAX_C per-channel stacks
    many = np.ones((sep_rank.MAX_R + 1, 3), np.float32)
    with pytest.raises(ValueError):
        sep_rank.pack(many, many, 3, 10, 10)  # above MAX_R ranks


def test_pack_cache_under_threads():
    """Threads packing overlapping stacks (the preview worker beside the
    caller) each get their own taps back, and the cache stays bounded."""
    rng = np.random.default_rng(11)
    stacks = [(rng.normal(size=(2, 5)).astype(np.float32),) * 2 for _ in range(cache.HOST_SIZE + 64)]
    errors = []

    def work(offset):
        try:
            for i in range(len(stacks)):
                u, v = stacks[(i + offset) % len(stacks)]
                p = sep_rank.pack(u.copy(), v.copy(), 3, 20, 30)
                # 5 taps run 8: one zero before them, two after
                want = np.concatenate([np.pad(t[r], (1, 2)) for r in range(2) for t in (u, v)])
                if not np.array_equal(p.taps[0], want):
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
    assert len(cache._host) <= cache.HOST_SIZE


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


@pytest.mark.parametrize(
    "w,offsets,vec",
    [(8208, (0, 0, 0), True), (8208, (0, 0, None), True), (8207, (0, 0, 0), False), (8208, (4, 0, 0), False),
     (8208, (0, 0, 8), False), (8208, (16, 0, 32), True), (300, (0, 0, None), True), (2, (0, 0, None), False)],
)
def test_print_encode_vector_path(w, offsets, vec):
    """K3's 16-byte loads and 4-byte stores take W a multiple of 4 and the
    density, output and colmat (None without the burn) 16-byte aligned."""
    ptrs = [None if o is None else 0x7F0000000000 + o for o in offsets]
    assert print_encode.vector_path(w, *ptrs) is vec


def test_burn_matrices_stay_on_the_device():
    """The burn's lerp matrices and its downsample's mean matrices are built
    and uploaded once per shape and factor: a second burn_smallmap of the
    same shape gets the same tensors, equal to the host builders'; another
    shape gets its own; the cache stays bounded."""
    d = torch.rand((3, 990, 1485)) * 2.0
    first = burn.burn_smallmap(d, 0.8, 10.0)
    second = burn.burn_smallmap(d * 0.5, 0.8, 10.0)
    assert first is not None and first[1] is second[1] and first[2] is second[2]
    assert first[1].is_contiguous() and first[2].is_contiguous()  # K3 takes them without a copy
    factor = 99  # ceil(990 / 10)
    hs, ws = 990 // factor, 1485 // factor
    rm = conv._lerp_matrix_full(hs, factor)
    np.testing.assert_array_equal(first[1].numpy(), rm)
    cm = conv._lerp_matrix_full(ws, factor)
    np.testing.assert_array_equal(first[2].numpy(), cm.T)
    dh = cache.on_device(("mean", hs, factor), None, "cpu")  # built by the burn's downsample
    np.testing.assert_array_equal(dh.numpy(), conv._mean_matrix(hs, factor))
    other = burn.burn_smallmap(torch.rand((3, 1000, 1485)), 0.8, 10.0)
    assert other[1] is not first[1] and other[1].shape == (1000, 10)
    np.testing.assert_array_equal(other[1][-10:].numpy(), np.repeat(conv._lerp_matrix_full(10, 100)[-1:], 10, 0))
    small = torch.rand((3, 300, 450))  # factor 6: the staged burn, its upsample on cached matrices too
    burn.burn(small, 0.8, 0.3, 50.0)
    uw = cache.on_device(("lerp_t", 75, 6), None, "cpu")
    assert uw.is_contiguous()
    np.testing.assert_array_equal(uw.numpy(), conv._lerp_matrix_full(75, 6).T)
    for n in range(cache.DEVICE_SIZE + 4):
        conv.box_downsample(torch.rand((1, 40 + n, 40)), 3)
    assert len(cache._device["cpu"]) <= cache.DEVICE_SIZE


def _fill(kind: str, device: str, n: int) -> None:
    """n distinct tables of ``kind`` on ``device``, each through its launch
    site: a box downsample's mean matrices, or a K2 stack above the
    struct's capacity (its launch into the fake library)."""
    for i in range(n):
        if kind == "matrix":
            conv.box_downsample(torch.zeros((1, 30 + 3 * i, 30), device=device), 3)
        else:
            u = np.full((9, 121), 0.01 + i / 1024, np.float32)
            sep_rank.fused_sep_rank(torch.zeros((3, 20, 30), device=device), u, u)


@pytest.mark.parametrize("kind", ["matrix", "taps"])
def test_device_tables_are_kept_per_device(fake_launch, kind):
    """Filling one device's table far past its bound, as frames on one card
    of a mesh do, evicts nothing of another device's entries: the oldest of
    that device's go, and it keeps at most DEVICE_SIZE."""
    _fill(kind, "meta", 2)
    kept = dict(cache._device["meta"])
    assert kept and all(t.device.type == "meta" for t in kept.values())
    _fill(kind, "cpu", 5 * cache.DEVICE_SIZE)
    assert len(cache._device["cpu"]) == cache.DEVICE_SIZE
    assert all(cache._device["meta"].get(k) is t for k, t in kept.items())


@pytest.mark.parametrize(
    "w,dtype,offsets,vec",
    [(8208, torch.uint16, (0, 0), True), (8208, torch.float32, (0, 0), True), (8204, torch.uint16, (0, 0), False),
     (8204, torch.float32, (0, 0), True), (8207, torch.uint16, (0, 0), False), (66, torch.float32, (0, 0), False),
     (64, torch.uint16, (2, 0), False), (64, torch.uint16, (4, 0), False), (64, torch.float32, (4, 0), False),
     (64, torch.float32, (8, 0), False), (64, torch.float32, (16, 0), True), (64, torch.uint16, (0, 8), False)],
)
def test_demosaic_path(w, dtype, offsets, vec):
    """K1's 16-byte path takes W a multiple of 8 (uint16) or 4 (float32)
    and a 16-byte aligned mosaic and output; every other shape goes to its
    general path."""
    from raw2film_tpu_torch.ops import demosaic

    assert demosaic.vec_path(w, dtype, *(0x7F0000000000 + o for o in offsets)) is vec


@pytest.mark.parametrize(
    "w,offsets,vec",
    [(2052, (0, 0), True), (1500, (0, 0), True), (2051, (0, 0), False), (30, (0, 0), False), (2052, (4, 0), False),
     (2052, (8, 0), False), (2052, (0, 4), False), (2052, (16, 32), True)],
)
def test_upsample_rows_path(w, offsets, vec):
    """K12's 16-byte path takes w a multiple of 4 and a 16-byte aligned
    input and output (the 45 MP and 24 MP /4 levels: w = 2052, 1500)."""
    assert pyramid.rows_vec_path(w, *(0x7F0000000000 + o for o in offsets)) is vec


class _FakeLib:
    """Stands in for the kernel library on the CPU: records each entry
    point's arguments (read at the call, while they are alive) and returns
    0, so a wrapper's launch can be inspected without a card."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            seen = list(args)
            if name == "r2f_demosaic" and args[10] is not None:
                seen[10] = np.ctypeslib.as_array((ctypes.c_float * 9).from_address(args[10].value)).copy()
            if name == "r2f_upsample_rows":
                seen[6] = args[6]._obj
            if name == "r2f_print_encode":
                seen[1] = np.ctypeslib.as_array((ctypes.c_float * print_encode.PVEC_LEN).from_address(args[1].value)).copy()
            if name == "r2f_develop":
                seen[2] = (args[2], np.ctypeslib.as_array((ctypes.c_float * develop.PARAMS).from_address(args[2])).copy())
            if name == "r2f_conv1d":
                t = sep_conv.Taps.from_address(args[5])
                seen[5] = (t.off, t.n, np.ctypeslib.as_array(t.t)[: min(t.n, sep_conv.MAX_TAPS)].copy(), args[5])
            taps = {"r2f_grain_apply": 9, "r2f_grain_field": 6}.get(name)
            if taps is not None:
                seen[taps] = np.ctypeslib.as_array((ctypes.c_float * args[taps + 1]).from_address(args[taps].value)).copy()
            self.calls.append((name, seen))
            return 0

        return call


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers' kernel path on CPU tensors, into a _FakeLib; the launch
    counts start from 0 and are restored afterwards (they are the
    ``launch.<kernel>`` counters of ``utils/trace.py``, which ``kb.launches``
    shows, so they are saved and set back rather than swapped for a copy)."""
    lib = _FakeLib()
    monkeypatch.setattr(kb, "use_kernel", lambda t: True)
    monkeypatch.setattr(kb, "require", lambda *a, **k: None)
    monkeypatch.setattr(kb, "lib", lambda: lib)
    monkeypatch.setattr(kb, "stream_ptr", lambda t: 0)
    saved = dict(kb.launches)
    kb.reset_launches()
    yield lib
    kb.launches.update(saved)


@pytest.mark.parametrize(
    "shape,f,oh,offset", [((3, 1368, 2052), 4, 5472, 0), ((3, 1000, 1500), 4, None, 0), ((2, 7, 30), 3, 20, 0),
                          ((1, 9, 64), 8, 70, 0), ((3, 11, 32), 4, 41, 1), ((3, 11, 32), 4, 41, 2)],
)
def test_upsample_rows_launch(fake_launch, shape, f, oh, offset):
    """K12's launch: the phase table of f by value (phases(f), the cached
    table), the shape and crop, and the path of rows_vec_path."""
    base = torch.zeros(int(np.prod(shape)) + offset)
    img = base[offset:].view(shape)
    out = pyramid.bilinear_upsample_rows(img, f, oh)
    (name, args), = fake_launch.calls
    assert name == "r2f_upsample_rows" and kb.launches["pyramid_up_rows"] == 1
    c, h, w = shape
    assert args[2:6] == [c, h, w, oh or h * f] and tuple(out.shape) == (c, oh or h * f, w)
    assert args[6] is pyramid.phases(f) and args[6].f == f
    assert args[7] == int(pyramid.rows_vec_path(w, img.data_ptr(), out.data_ptr())) == int(offset == 0 and w % 4 == 0)


@pytest.mark.parametrize("norm", [None, (512.0, 1.0 / 15000.0)], ids=["no-norm", "norm"])
@pytest.mark.parametrize(
    "dtype,w,offset", [(torch.uint16, 8208, 0), (torch.uint16, 8207, 0), (torch.uint16, 64, 1), (torch.uint16, 64, 2),
                       (torch.float32, 66, 0), (torch.float32, 64, 0), (torch.float32, 64, 1)],
)
def test_demosaic_launch(fake_launch, dtype, w, offset, norm):
    """K1's launch: the Bayer phase, the normalize pair, the 9 matrix
    values in float32 (or none) and the path of vec_path."""
    from raw2film_tpu_torch.ops import demosaic

    h = 6
    base = torch.zeros(h * w + offset, dtype=dtype)
    mosaic = base[offset:].view(h, w)
    mat = np.array([[0.9, 0.2, -0.1], [0.1, 1.1, -0.2], [-0.05, 0.15, 0.95]])
    out = demosaic.demosaic_exposure(mosaic, "GBRG", mat, norm)
    demosaic.demosaic_mhc(mosaic, "BGGR", norm)
    (n1, a1), (n2, a2) = fake_launch.calls
    assert n1 == n2 == "r2f_demosaic" and kb.launches["demosaic"] == 2
    assert a1[1] == int(dtype == torch.uint16) and a1[3:7] == [h, w, 1, 0] and a2[5:7] == [1, 1]
    assert a1[7:10] == ([1, 512.0, np.float32(1.0 / 15000.0)] if norm else [0, 0.0, 1.0])
    np.testing.assert_array_equal(a1[10], mat.astype(np.float32).ravel())
    assert a2[10] is None
    vec = demosaic.vec_path(w, dtype, mosaic.data_ptr(), out.data_ptr())
    assert a1[11] == int(vec) and vec == (offset == 0 and w % (8 if dtype == torch.uint16 else 4) == 0)


@pytest.mark.parametrize("pattern", ["RGGB", "GRBG", "GBRG", "BGGR"])
@pytest.mark.parametrize(
    "dtype,h,w,offset", [(torch.uint16, 6, 8208, 0), (torch.uint16, 41, 67, 0), (torch.uint16, 6, 64, 1),
                         (torch.float32, 6, 68, 0), (torch.float32, 6, 66, 0), (torch.float32, 6, 64, 2)],
)
def test_exposure_sample_launch(fake_launch, pattern, dtype, h, w, offset):
    """K15's launch: the Bayer phase, the normalize pair and the cam
    matrix's Y row in float32, the power 1 / factor in float32, the work
    buffer of EXPOSURE_BLOCKS partials and the sum, and the path of
    vec_path."""
    from raw2film_tpu_torch.ops import demosaic

    base = torch.zeros(h * w + offset, dtype=dtype)
    mosaic = base[offset:].view(h, w)
    cam = np.array([[0.9, 0.2, -0.1], [0.1, 1.1, -0.2], [-0.05, 0.15, 0.95]])
    total = demosaic.exposure_sum(mosaic, pattern, cam, (512.0, 1.0 / 23488.0), 5.47)
    (name, args), = fake_launch.calls
    assert name == "r2f_exposure_sample" and kb.launches["exposure_sample"] == 1
    assert args[:6] == [mosaic.data_ptr(), int(dtype == torch.uint16), h, w, *demosaic.PATTERNS[pattern]]
    assert args[6:8] == [512.0, np.float32(1.0 / 23488.0)]
    assert args[8:11] == [np.float32(v) for v in (0.1, 1.1, -0.2)] and args[11] == np.float32(1.0 / 5.47)
    assert args[12] == total.data_ptr() and args[13] == demosaic.EXPOSURE_BLOCKS
    assert total.dtype == torch.float64 and total.shape == (1,)
    assert total._base.numel() == demosaic.EXPOSURE_BLOCKS + 1
    vec = demosaic.vec_path(w, dtype, mosaic.data_ptr())
    assert args[14] == int(vec) and vec == (offset == 0 and w % (8 if dtype == torch.uint16 else 4) == 0)
    assert demosaic.exposure_samples(h, w) == -(-(h // 2) // 2) * -(-(w // 2) // 2)


@pytest.mark.parametrize("kind", ["host", "tensor"])
def test_print_encode_takes_the_host_print_vec(fake_launch, kind):
    """K3's 61 parameters go to the kernel by value: a host array (the
    bundle's pvec_host, as the render passes it) as it is, with no copy
    from the device; a tensor through the host."""
    vec = np.random.default_rng(4).normal(size=print_encode.PVEC_LEN).astype(np.float32)
    vec.setflags(write=False)
    pvec = vec if kind == "host" else torch.from_numpy(vec.copy())
    print_encode.print_encode(torch.zeros(3, 4, 8), pvec, "print", False, True, "sRGB")
    (name, args), = fake_launch.calls
    assert name == "r2f_print_encode" and kb.launches["print_encode"] == 1
    np.testing.assert_array_equal(args[1], vec)


@pytest.mark.parametrize("name", ["conv_w", "conv_h"])
@pytest.mark.parametrize("n,w,offset", [(23, 8208, 0), (23, 8207, 0), (23, 64, 1), (1, 64, 0), (301, 96, 0)])
def test_conv1d_takes_its_taps_by_value(fake_launch, monkeypatch, name, n, w, offset):
    """K5 / K6 pass their taps by value: a pointer to the struct that pack
    cached for the vector (the same one on every call), no device buffer up
    to MAX_TAPS packed taps, above it one buffer uploaded once; no call
    builds a tensor from host data. The 16-byte flag follows vec_path."""
    made = []
    for fn in ("tensor", "as_tensor"):
        real = getattr(torch, fn)
        monkeypatch.setattr(torch, fn, lambda *a, _real=real, **k: (made.append(a), _real(*a, **k))[1])
    t = np.random.default_rng(n + w).uniform(-0.2, 1.0, n).astype(np.float32)
    base = torch.zeros(2 * 3 * w + offset)
    img = base[offset:].view(2, 3, w)
    for _ in range(3):
        out = getattr(sep_conv, name)(img, list(t) if n == 1 else t)
    axis_code = 0 if name == "conv_w" else 1
    p = sep_conv.pack(t, axis_code)
    assert len(fake_launch.calls) == 3 and kb.launches[name] == 3
    for call, args in fake_launch.calls:
        assert call == "r2f_conv1d" and args[2:5] == [2, 3, w] and args[7] == axis_code
        off, count, taps, ptr = args[5]
        assert ptr == p.args_ptr and (off, count) == (p.off, p.taps.size)
        if p.by_value:
            assert args[6] is None
            np.testing.assert_array_equal(taps, p.taps)
        else:
            assert args[6] == cache.on_device(p.key, None, "cpu").data_ptr()
        assert args[8] == int(sep_conv.vec_path(w, img.data_ptr(), out.data_ptr())) == int(w % 4 == 0 and not offset)
    assert p.by_value is (n <= sep_conv.MAX_TAPS)
    assert len(made) == (0 if p.by_value else 1)  # the buffer, once


def test_conv1d_struct_matches_the_source():
    src = _source("conv1d.cu")
    assert sep_conv.MAX_TAPS == _constant("MAX_TAPS", "conv1d.cu")
    assert "sizeof(Taps) == 8 + 4 * MAX_TAPS" in src
    assert ctypes.sizeof(sep_conv.Taps) == 8 + 4 * sep_conv.MAX_TAPS
    fields = re.search(r"struct Taps \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"(\w+)(?:\[\w+\])?;", fields) == [f for f, _ in sep_conv.Taps._fields_]
    # K5's window alignment and tap groups, as the kernel reads them
    assert "tp.off % 4 != 0 || tp.n % 8 != 0" in src
    assert (sep_conv.K5_ALIGN, sep_conv.K5_GROUP) == (4, 8)


def _grain_sigma(n: int) -> float:
    """A correlation sigma whose grain_corr_taps has n taps."""
    from raw2film_tpu_torch.ops import grain

    sigma = {1: 0.2, 3: 0.547, 5: 0.8, 7: 1.2, 13: 2.3}[n]
    assert len(grain.grain_corr_taps(sigma)) == n
    return sigma


# (taps, W, storage offset in floats, path, 16-byte)
GRAIN_LAUNCHES = [
    (1, 4104, 0, "white", True), (1, 4103, 0, "white", False), (1, 64, 1, "white", False),
    (3, 8208, 0, "taps", True), (3, 130, 0, "taps", False), (3, 64, 2, "taps", False), (3, 64, 4, "taps", True),
    (5, 96, 0, "taps", True), (5, 97, 0, "taps", False), (7, 96, 0, "general", True), (13, 71, 0, "general", False),
]


@pytest.mark.parametrize("bw", [False, True], ids=["colour", "bw"])
@pytest.mark.parametrize("n,w,offset,path,vec", GRAIN_LAUNCHES)
def test_grain_apply_launch(fake_launch, n, w, offset, path, vec, bw):
    """K8's (K9's) launch: the shape, the seed pair with the row offset
    wrapped mod 2^32, the L2-normalised float32 taps, and the 16-byte flag
    of vec_path (W % 4, the density's and output's alignment; K9 takes none).
    The kernel follows from the tap count (grain_path)."""
    from raw2film_tpu_torch.ops import grain

    h = 5
    base = torch.zeros(3 * h * w + offset)
    d = base[offset:].view(3, h, w)
    prm = torch.arange(6, dtype=torch.float32)
    out = grain.grain_apply(d, (0xDEADBEEF, -7), _grain_sigma(n), prm, bw=bw)
    (name, args), = fake_launch.calls
    assert name == "r2f_grain_apply" and kb.launches["grain_apply_bw" if bw else "grain_apply"] == 1
    assert args[2:8] == [3, h, w, int(bw), 0xDEADBEEF, 2**32 - 7]
    taps = np.float32(grain.grain_corr_taps(_grain_sigma(n)))
    np.testing.assert_array_equal(args[9], taps)
    assert args[10] == n and grain.grain_path(n) == path
    assert args[11] == int(vec and not bw) == int(not bw and grain.vec_path(w, d.data_ptr(), out.data_ptr()))


@pytest.mark.parametrize("bw", [False, True], ids=["colour", "bw"])
@pytest.mark.parametrize("n,w,offset,path,vec", [c for c in GRAIN_LAUNCHES if c[2] == 0])
def test_grain_field_launch(fake_launch, monkeypatch, n, w, offset, path, vec, bw):
    """K7's launch: one channel for black-and-white grain (broadcast to
    three as a view), three for colour; the taps; the 16-byte flag of the
    fresh output (W % 4 alone)."""
    from raw2film_tpu_torch.ops import grain

    monkeypatch.setattr(kb, "use_kernel_on", lambda device: True)
    field = grain.grain_field((5, 3), (6, w), _grain_sigma(n), bw=bw, device="cpu")
    (name, args), = fake_launch.calls
    assert name == "r2f_grain_field" and kb.launches["grain_field"] == 1
    assert args[1:6] == [1 if bw else 3, 6, w, 5, 3]
    np.testing.assert_array_equal(args[6], np.float32(grain.grain_corr_taps(_grain_sigma(n))))
    assert args[7] == n and grain.grain_path(n) == path and args[8] == int(vec)
    assert tuple(field.shape) == (3, 6, w) and (field.stride(0) == 0) is bw


@pytest.mark.parametrize(
    "w,offsets,vec",
    [(8208, (0, 0), True), (4104, (0, 0), True), (4103, (0, 0), False), (4104, (4, 0), False), (4104, (0, 8), False),
     (4104, (16, 32), True), (4104, (0,), True), (2, (0,), False)],
)
def test_grain_vec_path(w, offsets, vec):
    """K7 / K8's 16-byte loads and stores take W a multiple of 4 and every
    buffer 16-byte aligned."""
    from raw2film_tpu_torch.ops import grain

    assert grain.vec_path(w, *(0x7F0000000000 + o for o in offsets)) is vec


def test_grain_paths():
    from raw2film_tpu_torch.ops import grain

    assert [grain.grain_path(n) for n in (1, 3, 5, 7, 9, 13, 31)] == ["white", "taps", "taps"] + ["general"] * 4


# K16: (3, H, W) exposures of the shapes its entry point takes the 16-byte
# path for (H * W a multiple of 4: 4 x 8, and 3 x 4 with W not one) and the
# 4-byte path for (H * W odd, a 1 x 1 frame, a contiguous view one float into
# its storage).
DEVELOP_LAUNCHES = [((4, 8), 0), ((3, 4), 0), ((5, 7), 0), ((1, 1), 0), ((4, 8), 1)]


@pytest.mark.parametrize("hw,offset", DEVELOP_LAUNCHES)
def test_develop_takes_its_parameters_by_value(fake_launch, hw, offset):
    """The render's development (``render.py::_develop``) on the kernel path
    hands K16 the exposure and a new output of its shape, the bundle's
    develop_host itself (its 31 floats, read by the C side and passed by
    value), the shape and the stream, and copies nothing to the device."""
    from raw2film_tpu_torch.pipeline import render
    from raw2film_tpu_torch.pipeline.render import load_film_bundle
    from raw2film_tpu_torch.utils import trace

    bundle, _ = load_film_bundle(device="cpu", halation=False, color_masking=0.5)
    h, w = hw
    base = torch.rand(3 * h * w + offset)
    ep = base[offset:].view(3, h, w)
    before = {k: v for k, v in trace.COUNTS.items() if k.startswith("copy.")}
    out = render._develop(ep, bundle)
    (name, args), = fake_launch.calls
    assert name == "r2f_develop" and kb.launches["develop"] == 1
    assert args[0] == ep.data_ptr() and args[1] == out.data_ptr() != ep.data_ptr()
    assert tuple(out.shape) == (3, h, w) and out.dtype == torch.float32 and out.is_contiguous()
    host = bundle["develop_host"]
    assert args[2][0] == host.ctypes.data
    np.testing.assert_array_equal(args[2][1], host)
    assert args[3:] == [h, w, 0]
    assert {k: v for k, v in trace.COUNTS.items() if k.startswith("copy.")} == before


def test_develop_refuses_bad_parameters(fake_launch):
    ep = torch.zeros(3, 4, 8)
    with pytest.raises(ValueError, match="develop parameters"):
        develop.develop(ep, np.zeros(develop.PARAMS, np.float64))
    with pytest.raises(ValueError, match="develop parameters"):
        develop.develop(ep, np.zeros(develop.PARAMS - 3, np.float32))
    with pytest.raises(ValueError, match="exposure"):
        develop.develop(torch.zeros(4, 4, 8), np.zeros(develop.PARAMS, np.float32))
    with pytest.raises(ValueError, match="develop parameters"):
        develop.host_params(0.0, [np.zeros(3)] * 6, np.zeros(3), np.eye(2))
    assert fake_launch.calls == []


def test_develop_params_match_the_source():
    """The host vector's length and layout, as csrc/develop.cu reads it."""
    src = _source("develop.cu")
    assert develop.PARAMS == _constant("PARAMS", "develop.cu") == 31
    for field in ("p[0]", "p[1 + c]", "p[19 + c]", "p[22 + k]"):
        assert field in src, field
    # the curve's factors: one fold (common.cuh) of the 19-float develop
    # vector that K14 reads and K16's host vector begins with
    common = _source("common.cuh")
    for field in ("v[4 + c]", "v[13 + c]", "v[16 + c]", "v[7 + c]", "v[10 + c]"):
        assert field in common, field
    assert "fold_curve2(p, c)" in src and "fold_curve2(dev, c)" in _source("halation.cu")
    assert halation.DEVELOP_LEN == 19


def _develop_emulated(ep: np.ndarray, p: np.ndarray) -> np.ndarray:
    """K16's arithmetic from the host vector, in float32 as csrc/develop.cu
    folds and applies it, with numpy's log2 and exp2 in place of the SFU's
    (which differ from them by about 2^-22)."""
    f32 = np.float32
    l2e, l10_2, ln2 = (f32(v) for v in (np.log2(np.e), np.log10(2.0), np.log(2.0)))
    dmin = p[19:22]
    q = []
    for c in range(3):
        gam, w_t, w_s = p[4 + c], p[13 + c], p[16 + c]
        a_t, a_s = l2e / w_t, l2e / w_s
        k1_t, k0_t, k1_s, k0_s = l10_2 * a_t, -p[7 + c] * a_t, l10_2 * a_s, -p[10 + c] * a_s
        g_t, g_s = gam * w_t * ln2, gam * w_s * ln2
        l2 = np.log2(np.maximum(ep[c] + p[0], f32(1e-6)))

        def sp2(t):
            return np.maximum(t, f32(0)) + np.log2(f32(1) + np.exp2(-np.abs(t)))

        q.append((p[1 + c] - dmin[c]) + g_t * sp2(l2 * k1_t + k0_t) - g_s * sp2(l2 * k1_s + k0_s))
    m = p[22:].reshape(3, 3)
    return np.stack([dmin[i] + (m[i, 0] * q[0] + m[i, 1] * q[1] + m[i, 2] * q[2]) for i in range(3)])


@pytest.mark.parametrize("negative,masking", [("Kodak Portra 400", 1.0), ("Kodak Portra 400", 0.5),
                                               ("Kodak Tri-X 400", 1.0)])
def test_develop_fold_tracks_the_plain_version(negative, masking):
    """K16's base-2 fold of the 31 host floats, emulated, against the plain
    development on exposures that reach the 1e-6 clamp (zeros, negatives)
    and the curve's shoulder: within the card's tolerance, 2e-5."""
    from raw2film_tpu_torch.pipeline import render
    from raw2film_tpu_torch.pipeline.render import load_film_bundle

    bundle, _ = load_film_bundle(negative, device="cpu", halation=False, color_masking=masking)
    rng = np.random.default_rng(16)
    ep = np.concatenate([rng.uniform(-0.05, 0.05, (3, 8, 64)), rng.uniform(0.0, 40.0, (3, 8, 64)),
                         np.zeros((3, 1, 64))], axis=1).astype(np.float32)
    want = render._develop_plain(torch.from_numpy(ep), bundle).numpy()
    got = _develop_emulated(ep, bundle["develop_host"])
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-5
