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
