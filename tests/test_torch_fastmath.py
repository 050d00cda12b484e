"""The port's exp2/log2 forms (raw2film_tpu_torch/ops/fastmath.py) against
the JAX package's (raw2film_tpu/ops/fastmath.py).

Two holds per function:

- against the same expression form evaluated in numpy float32 with
  correctly rounded exp2/log2 (computed in float64, rounded once): within
  2 ulp. This pins the port's forms and constants op for op;
- against the JAX functions on the CPU: within a bound derived from the
  accuracy each library documents and from how JAX lowers exp2 and log2
  (see ``SLEEF_ULP`` and ``XLA_ULP`` below), not from one machine's
  measurement: both libraries pick their code paths by CPU features, so a
  measured bound holds on the machine it was measured on only.

The unary functions are held to those bounds (test_unary); powc, softplus
and encode keep their measured bounds.

softplus is held in absolute terms (its log2(1 + tiny) branch makes the
relative ulp count of tiny results meaningless).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from raw2film_tpu.ops import fastmath as jfm
from raw2film_tpu_torch.ops import fastmath as tfm

F = np.float32


def _exp2(x):
    return np.exp2(np.asarray(x, np.float64)).astype(F)


def _log2(x):
    return np.log2(np.asarray(x, np.float64)).astype(F)


def _powc(x, p):
    return _exp2(_log2(np.maximum(x, F(1e-30))) * F(p))


def np_forms():
    """The JAX package's forms in numpy float32, correctly rounded exp2/log2."""
    l2_10, l10_2, l2e, ln2 = (F(np.log2(10.0)), F(np.log10(2.0)), F(np.log2(np.e)), F(np.log(2.0)))

    def softplus(u, w):
        w = F(w)
        t = u * (F(1.0) / w)
        return w * (np.maximum(t, F(0)) + ln2 * _log2(F(1.0) + _exp2(-np.abs(t) * l2e)))

    def encode(x, key):
        x = np.clip(x, F(0), F(1))
        if key == "Linear":
            return x
        if key in ("sRGB", "Display P3"):
            return np.where(x <= F(0.0031308), F(12.92) * x, F(1.055) * _powc(x, 1.0 / 2.4) - F(0.055))
        if key == "Rec709":
            return np.where(x < F(0.018), F(4.5) * x, F(1.099) * _powc(x, 0.45) - F(0.099))
        if key == "Gamma 2.2":
            return _powc(x, 1.0 / 2.2)
        if key == "Gamma 2.4":
            return _powc(x, 1.0 / 2.4)
        cut, a, b, c, d, e, f = (F(v) for v in (0.010591, 5.555556, 0.052272, 0.247190, 0.385537, 5.367655, 0.092809))
        return np.where(x > cut, c * l10_2 * _log2(a * x + b) + d, e * x + f)

    return {
        "pow10": lambda x: _exp2(x * l2_10),
        "log10": lambda x: _log2(x) * l10_2,
        "expe": lambda x: _exp2(x * l2e),
        "softplus": softplus,
        "powc": _powc,
        "encode": encode,
    }


def ulps_each(a, b) -> np.ndarray:
    """Distance in units in the last place of each pair of float32 values."""

    def key(v):
        i = np.asarray(v, F).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(key(a) - key(b))


def ulps(a, b) -> int:
    """Largest distance in units in the last place between two float32 arrays."""
    return int(ulps_each(a, b).max())


RNG = np.random.default_rng(20261016)
X_POW = RNG.uniform(-4.0, 2.0, 20000).astype(F)
X_LOG = np.exp(RNG.uniform(-14.0, 5.0, 20000)).astype(F)
X_EXP = RNG.uniform(-20.0, 5.0, 20000).astype(F)
X_SP = RNG.uniform(-5.0, 5.0, 20000).astype(F)
X_POWC = RNG.uniform(0.0, 1.2, 20000).astype(F)
_BREAKS = np.array([0.018, 0.0031308, 0.010591], F)
X_ENC = np.concatenate(
    [
        RNG.uniform(-0.1, 1.1, 20000).astype(F),
        _BREAKS,
        np.nextafter(_BREAKS, F(1)),
        np.nextafter(_BREAKS, F(0)),
    ]
)
GAMMAS = ["Linear", "sRGB", "Display P3", "Rec709", "Gamma 2.2", "Gamma 2.4", "ARRI LogC3"]

# What each library documents, in ulp of its own float32 result:
# - PyTorch's CPU exp2 runs SLEEF's u10 function in its vector loops
#   (Sleef_exp2f*_u10: at most 1.0 ulp) and the C library's exp2f (glibc:
#   under 1 ulp) on the remainder; its log2 is MKL VML's vmsLog2 in its
#   high-accuracy mode where torch is built with MKL (under 1 ulp), else
#   Sleef_log2f*_u10.
SLEEF_ULP = 1.0
# - JAX lowers exp2(t) to exp(float32(ln 2) * t) (jax/_src/lax/lax.py,
#   _exp2_lower) and log2(x) to log(x) / log(2) (jax/_src/numpy/ufuncs.py).
#   XLA states no error bound for its CPU exp and log; each is allowed 2 ulp,
#   twice SLEEF's.
XLA_ULP = 2.0
_LN2 = np.log(2.0)
_LN2_REL = abs(float(np.float32(_LN2)) - _LN2) / _LN2  # float32(ln 2)'s own error


def _form_bound_exp(x, c):
    """exp2(x * c), port against the correctly rounded form: SLEEF's error
    and the reference's half-ulp rounding, 1.5 ulp, so 2."""
    return np.full(x.shape, 2)


def _jax_bound_exp(x, c):
    """exp2(t), t = float32(x * c), port against exp(float32(ln 2) * t): the
    two kernels' errors, plus the rounding of y = ln 2 * t and the error of
    float32(ln 2), each a relative error of up to |y| 2^-24 (one ulp per
    unit of |y|), carried through exp."""
    y = np.abs(_LN2 * (x * np.float32(c)).astype(np.float64))
    return np.ceil(SLEEF_ULP + XLA_ULP + y * (1.0 + _LN2_REL * 2**24))


def _form_bound_log10(x, c):
    """log2(x) * c with c = float32(log10 2) in (1/4, 1/2): c * L lies one or
    two binades below L, so one ulp of L is up to 4c ulp of the product.
    The two log2 values differ by 1.5 ulp (SLEEF, and the reference's
    rounding) and each product rounds once: 1.5 * 4c + 1 = 2.81, so 3."""
    return np.full(x.shape, int(np.ceil((SLEEF_ULP + 0.5) * 4 * c + 1.0)))


def _jax_bound_log10(x, c):
    """Against log(x) / log(2) * c: SLEEF's log2, XLA's log of x and of 2 and
    the division's rounding, scaled by 4c, plus the two products' roundings:
    (1 + 2 + 2 + 0.5) * 4c + 1 = 7.6, so 8."""
    return np.full(x.shape, int(np.ceil((SLEEF_ULP + 2 * XLA_ULP + 0.5) * 4 * c + 1.0)))


# (name, inputs, port fn, jax fn, numpy form, the float32 constant of the
# form, per-element bounds against the form and against JAX)
UNARY = [
    ("pow10", X_POW, tfm.pow10, jfm.pow10, "pow10", tfm.LOG2_10, _form_bound_exp, _jax_bound_exp),
    ("log10", X_LOG, tfm.log10, jfm.log10, "log10", tfm.LOG10_2, _form_bound_log10, _jax_bound_log10),
    ("expe", X_EXP, tfm.expe, jfm.expe, "expe", tfm.LOG2_E, _form_bound_exp, _jax_bound_exp),
]


@pytest.mark.parametrize(
    "name,x,tf,jf,form,c,form_bound,jax_bound", UNARY, ids=[u[0] for u in UNARY]
)
def test_unary(name, x, tf, jf, form, c, form_bound, jax_bound):
    def port(arg=x):
        return tf(torch.from_numpy(arg)).numpy()

    got = port()
    _hold(name, "form", x, got, np_forms()[form](x), form_bound(x, c), port)
    _hold(name, "JAX", x, got, np.asarray(jf(jnp.asarray(x))), jax_bound(x, c), port)


def _hold(name, against, x, got, want, bound, port) -> None:
    """Every element within its ulp bound. A failure names the hold, the
    worst element (by distance over bound), its input, both values, its
    distance and its bound; where the elements over their bound lie (their
    index range, and whether it is one contiguous block: ATen splits a
    unary op into chunks of at least 2048 elements, one per intra-op
    thread, so one chunk's size points to one worker thread's state);
    ``torch.get_num_threads()``; what the port gives on a second call (a
    transient fault shows there) and on a fresh copy of the input (a fault
    of the input's memory shows there)."""
    dist = ulps_each(got, want)
    i = int(np.argmax(dist - bound))
    if dist[i] > bound[i]:
        over = np.flatnonzero(dist > bound)
        lo, hi = int(over[0]), int(over[-1])
        again = port()
        copied = port(np.array(x, copy=True))
        raise AssertionError(
            f"{name} against {against}: x[{i}]={x[i]!r} gives {got[i]!r}, want {want[i]!r}: "
            f"{int(dist[i])} ulp, bound {int(bound[i])} ({over.size} elements over, indices "
            f"{lo}..{hi}, {'one contiguous block' if hi - lo + 1 == over.size else 'scattered'}); "
            f"torch.get_num_threads() {torch.get_num_threads()}; "
            f"a second call gives {again[i]!r} ({int(np.sum(again != got))} elements differ from the first); "
            f"a copy of x gives {copied[i]!r} ({int(np.sum(copied[over] == got[over]))} of the "
            f"{over.size} wrong values again)"
        )


@pytest.mark.parametrize("p", [0.45, 1.0 / 2.4, 1.0 / 2.2])
def test_powc(p):
    got = tfm.powc(torch.from_numpy(X_POWC), p).numpy()
    assert ulps(got, np_forms()["powc"](X_POWC, p)) <= 2
    assert ulps(got, np.asarray(jfm.powc(jnp.asarray(X_POWC), p))) <= 16


@pytest.mark.parametrize("w", [0.35, 0.1, "tensor"])
def test_softplus(w):
    wv = F(0.23) if w == "tensor" else w
    warg = torch.tensor(wv) if w == "tensor" else w
    jarg = jnp.asarray(wv) if w == "tensor" else w
    got = tfm.softplus(torch.from_numpy(X_SP), warg).numpy()
    ref = np_forms()["softplus"](X_SP, wv)
    scale = F(wv) * (1.0 + np.abs(X_SP / F(wv)))
    eps = np.finfo(F).eps
    assert np.all(np.abs(got - ref) <= 2 * eps * scale)
    jgot = np.asarray(jfm.softplus(jnp.asarray(X_SP), jarg))
    assert np.all(np.abs(got - jgot) <= 16 * eps * scale)


@pytest.mark.parametrize("key", GAMMAS)
def test_encode(key):
    got = tfm.encode(torch.from_numpy(X_ENC), key).numpy()
    # a * x**p - b cancels near the sRGB/Rec709 breakpoints, which doubles
    # the relative size of the power's last-ulp error there
    form_bound = 4 if key in ("sRGB", "Display P3", "Rec709") else 2
    assert ulps(got, np_forms()["encode"](X_ENC, key)) <= form_bound
    assert ulps(got, np.asarray(jfm.encode(jnp.asarray(X_ENC), key))) <= 16


def test_encode_breakpoints():
    """Rec709 is linear strictly below 0.018; sRGB up to and including
    0.0031308; both sides agree with the JAX forms to the ulp bound."""
    for key, bp, strict in (("Rec709", 0.018, True), ("sRGB", 0.0031308, False)):
        x = np.array([np.nextafter(F(bp), F(0)), F(bp), np.nextafter(F(bp), F(1))], F)
        got = tfm.encode(torch.from_numpy(x), key).numpy()
        slope = F(4.5) if key == "Rec709" else F(12.92)
        linear = slope * x
        assert got[0] == linear[0]
        assert (got[1] == linear[1]) is not strict
        assert got[2] != linear[2]
        assert ulps(got, np.asarray(jfm.encode(jnp.asarray(x), key))) <= 16


def test_unknown_gamma_raises():
    with pytest.raises(ValueError):
        tfm.encode(torch.zeros(2), "Cineon")


def test_first_cpu_log2_runs_on_one_thread(monkeypatch):
    """The port's first ``torch.log2`` on the CPU in a process takes 16
    elements, which ATen runs on the calling thread alone (below its
    2048-element grain), before any larger input. That call sets up MKL
    VML's vmsLog2 (torch.log2's CPU form); a first call made by several
    OpenMP threads at once, while XLA's threads were busy, gave whole
    per-thread chunks of this file's X_LOG errors of up to 2.4e-5 in log2
    (the fault behind test_unary[log10]'s rare failures)."""
    calls = []
    real = torch.log2
    monkeypatch.setattr(tfm, "_log2_ready", False)
    monkeypatch.setattr(torch, "log2", lambda x: calls.append(x.numel()) or real(x))
    tfm.log10(torch.from_numpy(X_LOG))
    tfm.powc(torch.from_numpy(X_POWC), 0.45)
    assert calls == [16, X_LOG.size, X_POWC.size]
