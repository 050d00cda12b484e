"""K4, K5 and K6 against their Pallas kernels in interpret mode.

K4 (``pallas_conv2.fused_sep_rank``) is what the TPU runs where its K2
declines the shape (frames at most 512 px wide); the port's K2 kernel serves
those shapes, so K4's counterpart is ``sep_rank.fused_sep_rank`` there, held
to 1e-5. K5 and K6 (``conv_w``, ``conv_h``, composed by ``sep_conv`` and
``sep_conv_rank``) are ``ops/sep_conv.py``, held to 1e-6 at ragged shapes,
odd tap counts and a single tap (r = 0)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import raw2film_tpu  # noqa: F401
from raw2film_tpu.ops import pallas_conv2
from raw2film_tpu_torch.ops import sep_conv, sep_rank
from raw2film_tpu_torch.ops.conv import svd_separable

K4_TOL = 1e-5
CONV_TOL = 1e-6


def _img(c, h, w, seed):
    return np.random.default_rng(seed).uniform(0.0, 3.0, (c, h, w)).astype(np.float32)


def _ranks(n, rank, seed):
    """``rank`` separable terms of an n x n kernel (an SVD of a smooth
    kernel plus noise)."""
    rng = np.random.default_rng(seed)
    g = np.exp(-0.5 * ((np.arange(n) - n // 2) / (n / 4)) ** 2)
    k = np.outer(g, g) + 0.05 * rng.normal(size=(n, n))
    return svd_separable(k / k.sum(), tol=1e-6, max_rank=rank)


@pytest.mark.parametrize("shape", [(3, 200, 96), (2, 130, 300)], ids=["3x200x96", "2x130x300"])
def test_k4_shared_ranks(shape):
    """Shared ranks (the halation SVD tier, chroma NR) on frames the TPU's
    K2 declines: K4 runs, with chunk 512 above W."""
    u, v = _ranks(7, 3, 1)
    d = _img(*shape, 2)
    assert sep_rank.tpu_declines(shape[1], shape[2], 3)
    ref = pallas_conv2.fused_sep_rank(jnp.asarray(d), list(u), list(v), interpret=True)
    got = sep_rank.fused_sep_rank(torch.from_numpy(d), u, v).numpy()
    assert np.abs(got - np.asarray(ref)).max() <= K4_TOL


def test_k4_per_channel():
    """Per-channel ranks, zero-padded to a common rank (the small-kernel MTF
    of a narrow preview frame): the TPU runs K4 once per channel."""
    us, vs = zip(*(_ranks(9, r, 3 + c) for c, r in enumerate((2, 3, 1))))
    u3 = np.zeros((3, 3, 9), np.float32)
    v3 = np.zeros((3, 3, 9), np.float32)
    for c in range(3):
        u3[c, : len(us[c])], v3[c, : len(vs[c])] = us[c], vs[c]
    d = _img(3, 200, 96, 4)
    ref = np.concatenate([
        np.asarray(pallas_conv2.fused_sep_rank(jnp.asarray(d[c : c + 1]), list(us[c]), list(vs[c]),
                                               interpret=True))
        for c in range(3)
    ])
    got = sep_rank.fused_sep_rank(torch.from_numpy(d), u3, v3).numpy()
    assert np.abs(got - ref).max() <= K4_TOL


def test_tpu_declines():
    """K2 serves frames wider than 512 px and taller than two row tiles."""
    assert not sep_rank.tpu_declines(130, 600, 3) and not sep_rank.tpu_declines(5472, 8208, 11)
    assert sep_rank.tpu_declines(97, 600, 3) and sep_rank.tpu_declines(130, 512, 3)


# (shape, taps): ragged H and W, odd counts from 1 (r = 0) to 31. The JAX
# conv_h kernel cannot take one tap (its halo slice of width 0 is out of
# bounds); at H = 40 it hands the shape to its XLA form, which can.
CONVS = {
    "1tap": ((2, 40, 45), 1),
    "3taps": ((3, 70, 45), 3),
    "9taps": ((1, 71, 37), 9),
    "31taps": ((2, 90, 130), 31),
}


def _taps(n, seed):
    """Unit-sum taps with a negative lobe (and a zero, which is skipped as
    on the TPU), so the output stays near the unit range of the image."""
    t = np.random.default_rng(seed).uniform(-0.2, 1.0, n)
    if n > 3:
        t[1] = 0.0
    return (t / t.sum()).astype(np.float32)


@pytest.mark.parametrize("case", list(CONVS))
@pytest.mark.parametrize("axis", ["conv_w", "conv_h"])
def test_conv_matches_pallas(axis, case):
    shape, n = CONVS[case]
    d, t = _img(*shape, 6) / 3.0, _taps(n, 7)
    ref = np.asarray(getattr(pallas_conv2, axis)(jnp.asarray(d), t, interpret=True))
    got = getattr(sep_conv, axis)(torch.from_numpy(d), t).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= CONV_TOL


def test_sep_conv_rank_matches_pallas():
    u, v = _ranks(5, 2, 8)
    d = _img(3, 70, 60, 9)
    ref = np.asarray(pallas_conv2.sep_conv_rank(jnp.asarray(d), list(u), list(v), interpret=True))
    got = sep_conv.sep_conv_rank(torch.from_numpy(d), u, v).numpy()
    assert np.abs(got - ref).max() <= CONV_TOL
    one = sep_conv.sep_conv(torch.from_numpy(d), u[0], v[0]).numpy()
    ref1 = np.asarray(pallas_conv2.sep_conv(jnp.asarray(d), u[0], v[0], interpret=True))
    assert np.abs(one - ref1).max() <= CONV_TOL


def test_conv_refuses_even_taps():
    with pytest.raises(ValueError):
        sep_conv.conv_w(torch.zeros(1, 8, 8), np.ones(4, np.float32))


# ------------------------------------------------------------ K5 / K6 model
#
# numpy models of csrc/conv1d.cu's decomposition, in float32 with separate
# multiplies and adds, on the taps ops/sep_conv.py::pack hands the kernels:
# K6's staged windows of H_TR rows walked in runs of H_R rows and groups of
# H_R taps, K5's staged tiles of W_TH rows x (W_TW + chunk) columns in
# chunks of W_CH taps, both on their 16-byte and scalar paths. Each must
# reproduce conv1d_axis bit for bit.

import os  # noqa: E402
import re  # noqa: E402

from raw2film_tpu_torch.ops.conv import conv1d_axis  # noqa: E402

_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "raw2film_tpu_torch", "csrc",
                   "conv1d.cu")


def _const(name: str) -> int:
    with open(_CU) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


def _refl(i, n):
    """common.cuh::reflect101 on an index array."""
    i = np.asarray(i, np.int64)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    j = np.mod(i, period)
    return np.where((i >= 0) & (i < n), i, np.where(j >= n, period - j, j))


def _taps_of(p: sep_conv.Packed) -> np.ndarray:
    """The taps the kernel reads: the struct's (by value) or the device
    buffer's content (p.taps)."""
    if p.by_value:
        return np.ctypeslib.as_array(p.args.t)[: p.args.n].copy()
    return p.taps


def _init(n: int) -> np.float32:
    return np.float32(-0.0) if n > 0 else np.float32(0.0)


def model_conv_h(img: np.ndarray, t: np.ndarray, vec: bool) -> np.ndarray:
    """K6: per tile of H_TR = H_WY x H_R rows from yt (a block's H_T tiles
    in turn; the order changes no value), per chunk of H_CH taps from q0,
    the staged window: rows r < H_TR + len - 1 are image rows yt + off + q0
    + r (reflect-101), at every column (the scalar path's lanes past W read
    column W - 1 and store nothing). Warp w's run of H_R rows, lb = w H_R:
    per group of H_R taps from qb, cur holds window rows lb + qb + j, nxt
    rows lb + qb + H_R + j (loaded only for j < len - qb - 1, else 0); step
    s adds t[q0 + qb + s] times row k + s (cur, or nxt past H_R) to
    accumulator k: every term on cur first, then those on nxt."""
    hr, wy, hch = _const("H_R"), _const("H_WY"), _const("H_CH")
    tr = hr * wy
    p = sep_conv.pack(t, 1)
    taps, off, n = _taps_of(p), p.args.off, p.args.n
    c, h, w = img.shape
    assert not vec or w % 4 == 0
    wq = -(-w // 4) * 4
    src = np.concatenate([img, np.repeat(img[..., -1:], wq - w, axis=2)], axis=2)
    out = np.full((c, h, w), np.nan, np.float32)
    zero = np.zeros((c, wq), np.float32)
    for yt in range(0, h, tr):
        for lb in range(0, tr, hr):
            acc = np.full((hr, c, wq), _init(n), np.float32)
            for q0 in range(0, n, hch):
                length = min(hch, n - q0)

                def win(r):
                    assert r < tr + length - 1  # staged
                    return src[:, _refl(yt + off + q0 + r, h)]

                cur = [win(lb + k) for k in range(hr)]
                for qb in range(0, length, hr):
                    nxt = [win(lb + qb + hr + j) if j < length - qb - 1 else zero for j in range(hr)]
                    tq = [np.float32(taps[q0 + qb + s]) if qb + s < length else np.float32(0.0) for s in range(hr)]
                    for s in range(hr):  # the terms on cur, then those on nxt
                        if tq[s] != 0:
                            for k in range(hr - s):
                                acc[k] = acc[k] + tq[s] * cur[k + s]
                    for s in range(1, hr):
                        if tq[s] != 0:
                            for k in range(hr - s, hr):
                                acc[k] = acc[k] + tq[s] * nxt[k + s - hr]
                    cur = nxt
            for k in range(hr):
                if yt + lb + k < h:
                    out[:, yt + lb + k] = acc[k][..., :w]
    return out


def model_conv_w(img: np.ndarray, t: np.ndarray, vec: bool) -> np.ndarray:
    """K5: per W_TH x W_TW tile, per chunk of W_CH taps, the staged rows
    (rows past H clamped to H - 1) at image columns g0 + j, g0 = tile x +
    off + q0, in quads: a 16-byte copy where the quad lies inside the row,
    else reflect-101 value by value; then per group of 8 taps each thread's
    window of W_V + 8 columns from tile column (its quad) + qb, t[q0 + qb +
    s] times window column k + s into output k."""
    tx, ty, wy, wv, ch, wt = (_const(k) for k in ("W_TX", "W_TY", "W_Y", "W_V", "W_CH", "W_T"))
    tw, th = tx * wv, ty * wy
    p = sep_conv.pack(t, 0)
    taps, off, n = _taps_of(p), p.args.off, p.args.n
    assert off % 4 == 0 and n % 8 == 0
    c, h, w = img.shape
    out = np.full((c, h, w), np.nan, np.float32)
    # a block walks the tiles y0 + ti th, ti < W_T, one (tile, chunk) stage
    # at a time (the double buffering changes no value)
    starts = [y0 + ti * th for y0 in range(0, h, th * wt) for ti in range(min(wt, -(-(h - y0) // th)))]
    assert starts == list(range(0, h, th))
    for yt in starts:
        rows = img[:, np.minimum(np.arange(yt, yt + th), h - 1)]
        for xt in range(0, w, tw):
            acc = np.full((c, th, tw), _init(n), np.float32)
            for q0 in range(0, n, ch):
                length = min(ch, n - q0)
                g0 = xt + off + q0
                tile = np.empty((c, th, tw + ch), np.float32)
                for qd in range((tw + length) // 4):
                    g = g0 + 4 * qd
                    if vec and g >= 0 and g + 4 <= w:
                        tile[..., 4 * qd: 4 * qd + 4] = rows[..., g: g + 4]
                    else:
                        tile[..., 4 * qd: 4 * qd + 4] = rows[..., _refl(np.arange(g, g + 4), w)]
                for qb in range(0, length, 8):
                    # thread quad xl reads tile columns xl + qb .. xl + qb + 11
                    for s in range(8):
                        tq = np.float32(taps[q0 + qb + s])
                        if tq != 0:
                            acc = acc + tq * tile[..., qb + s: qb + s + tw]
            ys, xs = min(th, h - yt), min(tw, w - xt)
            out[:, yt: yt + ys, xt: xt + xs] = acc[:, :ys, :xs]
    return out


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _model_taps(n: int, seed: int, zeros: str) -> np.ndarray:
    t = _taps(n, seed)
    if zeros == "ends" and n >= 5:
        t[:2] = 0.0
        t[-1] = 0.0
    if zeros == "all":
        t[:] = 0.0
    if zeros == "neg":
        t = -t
    return t


# (shape, taps, zeros): n in {1, 3, 9, 23, 31}; above the by-value cap; n > H
# and n > W; H below a run; W % 4 != 0; C = 1; zero taps at the ends and
# everywhere; negative taps (signed zeros from the products)
MODEL_CASES = {
    "1tap": ((2, 19, 20), 1, ""),
    "3taps-ragged": ((3, 21, 45), 3, ""),
    "9taps-c1": ((1, 37, 36), 9, "ends"),
    "23taps": ((3, 40, 300), 23, ""),
    "23taps-w-odd": ((2, 29, 261), 23, "neg"),
    "31taps": ((2, 45, 130), 31, ""),
    "n-over-h-w": ((2, 5, 14), 31, ""),
    "h-below-run": ((1, 3, 40), 9, ""),
    "h1-w1": ((1, 1, 1), 3, ""),
    "all-zero": ((1, 11, 12), 5, "all"),
    "above-cap": ((1, 9, 300), 301, ""),
    "above-cap-w-odd": ((1, 7, 263), 259, "ends"),
}


# the 16-byte path needs W % 4 == 0: other shapes take the scalar path only
MODEL_RUNS = [
    pytest.param(axis, case, vec, id=f"{axis}-{case}-{'16-byte' if vec else 'scalar'}")
    for axis in ("conv_w", "conv_h") for case, (shape, _, _) in MODEL_CASES.items()
    for vec in (True, False) if not (vec and shape[2] % 4)
]


@pytest.mark.parametrize("axis,case,vec", MODEL_RUNS)
def test_kernel_model_is_bit_equal_to_plain(axis, case, vec):
    shape, n, zeros = MODEL_CASES[case]
    d = (_img(*shape, 11) - 1.5).astype(np.float32)
    d[0, 0, 0] = -0.0
    t = _model_taps(n, 12, zeros)
    model = model_conv_w if axis == "conv_w" else model_conv_h
    got = model(d, t, vec)
    ref = conv1d_axis(torch.from_numpy(d), t, -1 if axis == "conv_w" else -2).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("n", [1, 3, 9, 23, 31, 257])
def test_pack_trims_and_aligns(n):
    """pack keeps the span of the nonzero taps at its window offset; for K5
    the offset is a multiple of 4 and the count of 8, the extra taps zero;
    read back as a centred vector, both packings give the input."""
    t = _model_taps(n, 3, "ends")
    r = n // 2
    for axis_code in (0, 1):
        p = sep_conv.pack(t, axis_code)
        taps = _taps_of(p)
        assert p.by_value is (taps.size <= sep_conv.MAX_TAPS)
        if axis_code == 0:
            assert p.args.off % 4 == 0 and taps.size % 8 == 0 and p.args.off > -r - 4
        else:
            assert taps[0] != 0 and taps[-1] != 0
        back = np.zeros(2 * max(r, taps.size) + 9, np.float32)
        c = back.size // 2
        back[c + p.args.off: c + p.args.off + taps.size] = taps
        want = np.zeros_like(back)
        want[c - r: c + r + 1] = t
        np.testing.assert_array_equal(back, want)
        assert sep_conv.pack(t.copy(), axis_code) is p  # cached by content


def test_pack_of_zero_taps_is_empty():
    for axis_code in (0, 1):
        p = sep_conv.pack(np.zeros(7, np.float32), axis_code)
        assert p.args.n == 0 and p.args.off == 0 and p.by_value
