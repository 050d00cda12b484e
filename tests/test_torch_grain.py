"""K7 and K8 as ``csrc/grain.cu`` computes them, emulated in numpy on the CPU
and held to their plain versions (``grain_field_hash``, ``grain_apply_plain``).

The emulation follows each kernel path's structure: the white-noise path's
runs (a warp's row piece, V columns a lane, WHITE_R rows a warp, the LCG
steps hoisted per column and per row), the compiled-tap path's window (which
thread hashes which cell, its row stride and padding, the halo columns
right of the tile) and its register runs (TAPS_R rows x V columns a thread,
a ring of N window rows, the column pass with the noise's 1/4 folded into
its taps, then the row pass), and the general path's tile; the stores of
the 16-byte and the value-by-value paths; the noise as S - 32 from the
float trick that replaces I2F. It keeps the plain version's order of
operations (a multiply, then an add, in float32; the kernels fuse them),
so every case is bit for bit: the fold, the conversion and the indexing
are exact. Tile constants are read from the kernel source."""

import os
import re

import numpy as np
import pytest
import torch

from raw2film_tpu_torch.ops import grain

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "raw2film_tpu_torch", "csrc")
with open(os.path.join(CSRC, "grain.cu")) as _f:
    SOURCE = _f.read()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


WARPS, V, WHITE_R, TAPS_R = (_constant(n) for n in ("WARPS", "V", "WHITE_R", "TAPS_R"))
GTW, GTY, GRPT = (_constant(n) for n in ("GTW", "GTY", "GRPT"))
NT, TW, GTH = 32 * WARPS, 32 * V, GTY * GRPT
M = np.uint64(0xFFFFFFFF)
PRM = torch.tensor([0.03, 0.15, 0.31, 2.2, 0.12, 0.28])
SIGMAS = {1: 0.2, 3: 0.547, 5: 0.8, 13: 2.3}  # the 45 MP frame has 3 taps, the half-size one 1


def _u32(v) -> np.ndarray:
    return np.asarray(v, np.int64).astype(np.uint64) & M


def _lcg(v):
    return (_u32(v) * np.uint64(1664525) + np.uint64(1013904223)) & M


def _pcg3d_row(X, Y, Z, yz):
    """common.cuh::pcg3d_row in uint64 masked to 32 bits (no product
    overflows 64)."""
    v0 = (X + yz) & M
    v1 = (Y + Z * v0) & M
    v2 = (Z + v0 * v1) & M
    v0, v1, v2 = (v ^ (v >> np.uint64(16)) for v in (v0, v1, v2))
    a = (v0 + v1 * v2) & M
    return a, (v1 + v2 * a) & M


def _popcount(v):
    v = v - ((v >> np.uint64(1)) & np.uint64(0x55555555))
    v = (v & np.uint64(0x33333333)) + ((v >> np.uint64(2)) & np.uint64(0x33333333))
    v = (v + (v >> np.uint64(4))) & np.uint64(0x0F0F0F0F)
    return ((v * np.uint64(0x01010101)) & M) >> np.uint64(24)


def _centred(a, b) -> np.ndarray:
    """common.cuh::grain_centred: (0x4B000000 | S) as a float, less 2^23 + 32."""
    s = (_popcount(a) + _popcount(b)).astype(np.uint32)
    return (np.uint32(0x4B000000) | s).view(np.float32) - np.float32(8388640.0)


def _noise_rows(xs, ys, c, seed, row_off) -> np.ndarray:
    """S - 32 at columns xs of rows ys, the column steps X hoisted, yz per row."""
    Z = _lcg((c * grain.GOLDEN + seed) & 0xFFFFFFFF)
    X = _lcg(xs)[None, :]
    Y = _lcg(_u32(np.asarray(ys, np.int64)) + np.uint64(row_off))[:, None] & M
    return _centred(*_pcg3d_row(X, Y, Z, (Y * Z) & M))


def _taps(n):
    t = np.float32(grain.grain_corr_taps(SIGMAS[n]))
    assert len(t) == n
    return t


class _Out:
    """The output planes, NaN until stored; each value stored once."""

    def __init__(self, c, h, w):
        self.v = np.full((c, h, w), np.nan, np.float32)
        self.n = np.zeros((c, h, w), np.int32)

    def store_runs(self, c, y, x, vals, w, vec):
        """A warp's runs at row y, lane l's at x[l]..x[l]+V-1 (vals (32, V)):
        16-byte pieces wholly inside the row (W % 4 == 0) or value by value
        up to W."""
        cols = x[:, None] + np.arange(V)[None, :]
        if vec:
            piece = (x[:, None] + (np.arange(V) // 4 * 4)[None, :]) < w
            assert not (piece & (cols >= w)).any(), "a 16-byte piece past the row"
            keep = piece
        else:
            keep = cols < w
        self.put(c, y, cols[keep], vals[keep])

    def put(self, c, y, xs, vals):
        self.v[c, y, xs] = vals
        self.n[c, y, xs] += 1

    def done(self):
        assert (self.n == 1).all(), "every output stored exactly once"
        return self.v


class _Dens:
    """The densities and their amplitudes rms_eff * shape(d), the latter
    evaluated once on the whole image as the plain version does (torch's
    exp on the CPU may differ by an ulp between its vector and tail
    paths)."""

    def __init__(self, d):
        self.d = d
        self.amp = grain.grain_amplitude(torch.from_numpy(d), PRM).numpy()

    def runs(self, c, y, x, w):
        """(densities, amplitudes) of a warp's runs at row y (0 past the row)."""
        cols = x[:, None] + np.arange(V)[None, :]
        at = (c, y, np.minimum(cols, w - 1))
        return tuple(np.where(cols < w, a[at], np.float32(0.0)).astype(np.float32) for a in (self.d, self.amp))


LANES = np.arange(32)


def emulate_white(c_n, h, w, seed, row_off, vec, d=None):
    """The white-noise kernel (1 tap): K7's m / 4, or K8 with the 1/4 folded
    into rms_eff."""
    out = _Out(c_n, h, w)
    th = WARPS * WHITE_R
    for c in range(c_n):
        for by in range(-(-h // th)):
            for bx in range(-(-w // TW)):
                x = bx * TW + LANES * V
                x = x[x < w]  # the lanes past W return
                if not x.size:
                    continue
                xs = (x[:, None] + np.arange(V)[None, :]).ravel()
                for warp in range(WARPS):
                    y0 = (by * WARPS + warp) * WHITE_R
                    for k in range(WHITE_R):
                        y = y0 + k
                        if y >= h:
                            break
                        m = _noise_rows(xs, [y], c, seed, row_off)[0].reshape(-1, V)
                        if d is None:
                            vals = np.float32(0.25) * m
                        else:
                            dv, amp = d.runs(c, y, x, w)
                            amp4 = amp * np.float32(0.25)  # (rms / 4) shape == (rms shape) / 4
                            vals = np.maximum(dv + amp4 * m, np.float32(0.0))
                        out.store_runs(c, y, x, vals, w, vec)
    return out.done()


def _stride(n):
    nl = (V + n - 1 + 3) // 4
    return max((TW + n - 1 + 3) & ~3, 31 * V + 4 * nl), nl


def emulate_taps(c_n, h, w, seed, row_off, taps, vec, d=None):
    """The compiled-tap kernel: the block's window (main runs by warp and
    lane, then the halo from the last threads), then each thread's ring of
    window rows, column pass (folded taps) and row pass."""
    n = len(taps)
    tr = np.float32(taps)
    tc = np.float32(0.25) * tr
    gh, (gs, nl) = WARPS * TAPS_R + n - 1, _stride(n)
    rw = V + n - 1
    out = _Out(c_n, h, w)
    for c in range(c_n):
        for by in range(-(-h // (WARPS * TAPS_R))):
            for bx in range(-(-w // TW)):
                x0, y0 = bx * TW, by * WARPS * TAPS_R
                win = np.full((gh, gs), np.nan, np.float32)
                hashed = np.zeros((gh, gs), np.int32)
                for warp in range(WARPS):
                    ly = np.arange(warp, gh, WARPS)
                    win[ly, :TW] = _noise_rows(np.arange(x0, x0 + TW), y0 + ly, c, seed, row_off)
                    hashed[ly, :TW] += 1
                i = np.concatenate([np.arange(NT - 1 - tid, gh * (n - 1), NT) for tid in range(NT)])
                ly, lx = i // (n - 1), TW + i % (n - 1)
                for a, b in zip(ly, lx):
                    win[a, b] = _noise_rows(np.array([x0 + b]), [y0 + a], c, seed, row_off)[0, 0]
                    hashed[a, b] += 1
                assert (hashed[:, : TW + n - 1] == 1).all() and not hashed[:, TW + n - 1:].any()
                x = x0 + LANES * V
                live = x < w  # the lanes past W return after the barrier
                x = x[live]
                if not x.size:
                    continue
                cols = (LANES[live] * V)[:, None] + np.arange(4 * nl)[None, :]
                assert cols.max() < gs  # the 16-byte loads stay in the row
                for warp in range(WARPS):
                    yt = y0 + warp * TAPS_R
                    ring = [None] * n
                    for k in range(TAPS_R + n - 1):
                        ring[k % n] = win[warp * TAPS_R + k][cols][:, :rw]
                        assert not np.isnan(ring[k % n]).any()
                        if k < n - 1:
                            continue
                        r = k - (n - 1)
                        cs = tc[0] * ring[r % n]
                        for q in range(1, n):
                            cs = cs + tc[q] * ring[(r + q) % n]
                        f = tr[0] * cs[:, :V]
                        for q in range(1, n):
                            f = f + tr[q] * cs[:, q: q + V]
                        y = yt + r
                        if y >= h:
                            continue
                        if d is not None:
                            dv, amp = d.runs(c, y, x, w)
                            f = np.maximum(dv + amp * f, np.float32(0.0))
                        out.store_runs(c, y, x, f, w, vec)
    return out.done()


def emulate_general(c_n, h, w, seed, row_off, taps, d=None):
    """The general kernel: a GTH x GTW tile, its window hashed by warps on
    rows and lanes on columns, the column pass into the tile's buffer, then
    GRPT rows a thread."""
    n = len(taps)
    tr = np.float32(taps)
    gh, gw = GTH + n - 1, GTW + n - 1
    out = _Out(c_n, h, w)
    for c in range(c_n):
        for by in range(-(-h // GTH)):
            for bx in range(-(-w // GTW)):
                x0, y0 = bx * GTW, by * GTH
                win = np.full((gh, gw), np.nan, np.float32)
                for ly in range(gh):  # warps on rows, lanes on columns: every cell once
                    win[ly] = np.float32(0.25) * _noise_rows(np.arange(x0, x0 + gw), [y0 + ly], c, seed, row_off)[0]
                col = tr[0] * win[:GTH]
                for q in range(1, n):
                    col = col + tr[q] * win[q: q + GTH]
                for ty in range(GTY):
                    for k in range(GRPT):
                        row, y = ty + GTY * k, y0 + ty + GTY * k
                        if y >= h:
                            break
                        nx = min(GTW, w - x0)
                        f = tr[0] * col[row, :nx]
                        for q in range(1, n):
                            f = f + tr[q] * col[row, q: q + nx]
                        if d is not None:
                            dv, amp = d.d[c, y, x0: x0 + nx], d.amp[c, y, x0: x0 + nx]
                            f = np.maximum(dv + amp * f, np.float32(0.0))
                        out.put(c, y, slice(x0, x0 + nx), f)
    return out.done()


def emulate(c_n, h, w, seed, row_off, taps, vec, d=None):
    d = None if d is None else _Dens(d)
    path = grain.grain_path(len(taps))
    if path == "white":
        return emulate_white(c_n, h, w, seed, row_off, vec, d)
    if path == "taps":
        return emulate_taps(c_n, h, w, seed, row_off, taps, vec, d)
    return emulate_general(c_n, h, w, seed, row_off, taps, d)


# (H, W): ragged in both (tiles at every edge, runs cut by W), a multiple of
# the tiles, narrower and shorter than one tile, one row
SHAPES = [(70, 133), (70, 132), (64, 128), (5, 7), (1, 4)]
SEED = 0x9E3779B9 ^ 12345


@pytest.mark.parametrize("row_off", [37, (-7) & 0xFFFFFFFF], ids=["row-off", "negative-row-off"])
@pytest.mark.parametrize("hw", SHAPES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("n", [1, 3, 5, 13])
def test_grain_field_emulation(n, hw, row_off):
    """K7: every path, vec and scalar where W allows, bit for bit with
    grain_field_hash."""
    h, w = hw
    taps = _taps(n)
    want = grain.grain_field_hash(SEED, hw, taps, row_off, channels=3).numpy()
    for vec in ([False, True] if w % 4 == 0 else [False]):
        np.testing.assert_array_equal(emulate(3, h, w, SEED, row_off, taps, vec), want)


@pytest.mark.parametrize("row_off", [37, (-7) & 0xFFFFFFFF], ids=["row-off", "negative-row-off"])
@pytest.mark.parametrize("hw", SHAPES[:4], ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("n", [1, 3, 5, 13])
def test_grain_apply_emulation(n, hw, row_off):
    """K8: every path, vec and scalar where W allows, bit for bit with
    grain_apply_plain (densities read at the outputs' positions)."""
    h, w = hw
    taps = _taps(n)
    d = np.random.default_rng(n + h).uniform(0.0, 3.0, (3, h, w)).astype(np.float32)
    want = grain.grain_apply_plain(torch.from_numpy(d), (SEED, row_off), taps, PRM).numpy()
    for vec in ([False, True] if w % 4 == 0 else [False]):
        np.testing.assert_array_equal(emulate(3, h, w, SEED, row_off, taps, vec, d), want)


@pytest.mark.parametrize("x0,y0,c,seed,row_off", [(0, 0, 0, 0, 0), (8150, 5430, 2, 0xFFFFFFFF, 0),
                                                   (3, 17, 1, 0xDEADBEEF, (-5) & 0xFFFFFFFF),
                                                   (70000, 90000, 2, 7, 2**31 - 3)])
def test_hoisted_hash_words(x0, y0, c, seed, row_off):
    """pcg3d_row with the LCG steps and Y * Z hoisted gives PCG-3D's words."""
    xs, ys = np.arange(x0, x0 + 40), np.arange(y0, y0 + 24)
    Z = _lcg((c * grain.GOLDEN + seed) & 0xFFFFFFFF)
    Y = _lcg(_u32(ys) + np.uint64(row_off))[:, None]
    a, b = _pcg3d_row(_lcg(xs)[None, :], Y, Z, (Y * Z) & M)
    wa, wb = grain.hash_words(24, 40, x0, y0, c, seed, row_off)
    np.testing.assert_array_equal(a.astype(np.int64), wa.numpy())
    np.testing.assert_array_equal(b.astype(np.int64), wb.numpy())


def test_centred_conversion_every_sum():
    """For every S in 0..64: (0x4B000000 | S) as a float less 8388640 is
    S - 32 exactly, and a quarter of it the binomial normal."""
    s = np.arange(65, dtype=np.uint32)
    got = (np.uint32(0x4B000000) | s).view(np.float32) - np.float32(8388640.0)
    np.testing.assert_array_equal(got, s.astype(np.float32) - np.float32(32.0))
    np.testing.assert_array_equal(got * np.float32(0.25), (s.astype(np.float32) - 32) * np.float32(0.25))


@pytest.mark.parametrize("n", [3, 5, 13])
def test_tap_fold_is_exact(n):
    """(t / 4) m == t (m / 4) in float32 for every noise value m and tap t
    (the 45 MP taps among them), rounded once, and as exact products (the
    kernels fuse them into FMAs)."""
    t = _taps(n)[:, None]
    m = np.arange(-32, 33, dtype=np.float32)[None, :]
    np.testing.assert_array_equal((np.float32(0.25) * t) * m, t * (np.float32(0.25) * m))
    np.testing.assert_array_equal(np.float64(np.float32(0.25) * t) * m, np.float64(t) * np.float64(m / 4))
