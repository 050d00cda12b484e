"""The port's print/encode tail (kernel K3's plain version on the CPU), with
and without the burn prologue, against the JAX package: the Pallas kernel in
interpret mode (burn arguments from the JAX burn_smallmap) and the XLA
planes tail (_print_tail, after the JAX staged burn).

Tolerance: 1 uint8 code, or 1e-4 (0.03 of a code) on the encoded float
image: XLA:CPU's float32 exp2 is up to 9 ulp from the correctly rounded
value, and the steep transfer curves near black (Gamma 2.2/2.4) and the
10^-d of dense shadows amplify that past 1e-5."""

import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import raw2film_tpu  # noqa: F401
from raw2film_tpu.ops import burn as jburn
from raw2film_tpu.ops.pallas_print import pack_print_vec, print_encode_pallas
from raw2film_tpu.pipeline.render import RenderConfig, _print_tail
from raw2film_tpu_torch import convert
from raw2film_tpu_torch.ops import burn as tburn
from raw2film_tpu_torch.ops import print_encode as pe
from raw2film_tpu_torch.pipeline import render as trender

FLOAT_TOL = 1e-4


def _bundle(rng, hb=0.0):
    r3 = lambda lo, hi: jnp.asarray(rng.uniform(lo, hi, 3), jnp.float32)
    m3 = lambda s: jnp.asarray(np.eye(3) + rng.normal(0, s, (3, 3)), jnp.float32)
    return {
        "a": m3(0.1),
        "log_e0": r3(-0.5, 0.5),
        "prt_curve": (r3(0.05, 0.15), r3(1.5, 3.0), r3(-1.2, -0.8), r3(0.6, 1.0), r3(0.15, 0.3), r3(0.15, 0.3)),
        "d_offset": r3(0.0, 0.4),
        "v": m3(0.05),
        "shadow_comp": jnp.float32(0.35),
        "shadow_ref": jnp.float32(1.8),
        "vd_offset": r3(-2.2, -1.8),
        "to_display": m3(0.2),
        "white_gain": r3(0.9, 1.1),
        "sat": jnp.float32(1.3),
        "highlight_burn": jnp.float32(hb),
    }


# Every print mode, shadow comp on and off, non-neutral saturation and every
# transfer function.
CASES = [
    ("print", False, True, "sRGB"),
    ("print", True, False, "Rec709"),
    ("print", True, True, "Display P3"),
    ("inversion", False, False, "Gamma 2.2"),
    ("inversion", True, True, "Gamma 2.4"),
    ("direct", True, True, "ARRI LogC3"),
    ("direct", False, False, "Linear"),
    ("print", False, False, "ARRI LogC3"),
]


def _cfg(mode, shadow, sat_neutral, gamma, quantize):
    return RenderConfig(
        scale=20.0, halation=False, sharpness=False, grain=0, highlight_burn=False,
        print_mode=mode, shadow_comp=shadow, sat_neutral=sat_neutral, gamma_func=gamma,
        quantize=quantize,
    )


def _max_diff(got, ref):
    return np.abs(got.astype(np.float64) - np.asarray(ref).astype(np.float64)).max()


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_tail_matches_jax(case):
    """The float output against both references; the uint8 output against
    their rounding (the references' quantize step is jnp.round(255 * x))."""
    mode, shadow, sat_neutral, gamma = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    jb = _bundle(rng)
    d = rng.uniform(0.0, 3.5, (3, 64, 256)).astype(np.float32)
    tb = convert.bundle_from_numpy(jb)
    pvec = pe.pack_print_vec(tb)
    got = pe.print_encode(torch.from_numpy(d), pvec, mode, shadow, sat_neutral, gamma, False).numpy()
    got_u8 = pe.print_encode(torch.from_numpy(d), pvec, mode, shadow, sat_neutral, gamma, True).numpy()
    assert got.dtype == np.float32 and got_u8.dtype == np.uint8 and got.shape == (3, 64, 256)
    cfg = _cfg(mode, shadow, sat_neutral, gamma, False)
    refs = {
        "pallas": print_encode_pallas(
            jnp.asarray(d), pack_print_vec(jb), mode, shadow, sat_neutral, gamma, quantize=False, interpret=True
        ),
        "xla": _print_tail(jnp.asarray(d), jb, cfg),
    }
    for name, ref in refs.items():
        assert _max_diff(got, ref) <= FLOAT_TOL, (name, _max_diff(got, ref))
        assert _max_diff(got_u8, np.round(np.asarray(ref) * 255.0)) <= 1, name
    cfg_u8 = convert.config_from_jax(_cfg(mode, shadow, sat_neutral, gamma, True))
    np.testing.assert_array_equal(trender._print_tail(torch.from_numpy(d), tb, cfg_u8).numpy(), got_u8)


@pytest.mark.parametrize("quantize", [True, False], ids=["u8", "float"])
def test_burn_prologue_matches_jax(quantize):
    """416 x 640 gives a burn factor of 9, so the small-map path serves."""
    rng = np.random.default_rng(9)
    jb = _bundle(rng, hb=0.3)
    d = rng.uniform(0.0, 3.0, (3, 416, 640)).astype(np.float32)
    d[1, 100:200, 300:420] += 1.0  # a highlight for the glow
    jd = jnp.asarray(d)
    td = torch.from_numpy(d)
    jargs = jburn.burn_smallmap(jd, 1.0, 50.0)
    targs = tburn.burn_smallmap(td, torch.tensor(1.0), 50.0)
    assert jargs is not None and targs is not None
    assert targs[0].shape == (46, 71)
    assert np.abs(targs[0].numpy() - np.asarray(jargs[0])).max() <= 1e-6
    np.testing.assert_array_equal(targs[1].numpy(), np.asarray(jargs[1]))
    np.testing.assert_array_equal(targs[2].numpy(), np.asarray(jargs[2]))
    tb = convert.bundle_from_numpy(jb)
    mode, shadow, sat_neutral, gamma = CASES[1]
    got = pe.print_encode(td, pe.pack_print_vec(tb), mode, shadow, sat_neutral, gamma, quantize, targs).numpy()
    tol = 1 if quantize else FLOAT_TOL
    pallas = print_encode_pallas(
        jd, pack_print_vec(jb), mode, shadow, sat_neutral, gamma, quantize=quantize, interpret=True, burn=jargs
    )
    assert _max_diff(got, pallas) <= tol
    staged = jburn.burn(jd, 1.0, jb["highlight_burn"], 50.0)
    ref = _print_tail(staged, jb, _cfg(mode, shadow, sat_neutral, gamma, quantize))
    assert _max_diff(got, ref) <= tol


def test_staged_burn_matches_jax():
    """A burn factor of 6 (256 x 384): no small map, the staged burn runs."""
    rng = np.random.default_rng(4)
    d = rng.uniform(0.0, 3.0, (3, 256, 384)).astype(np.float32)
    assert tburn.burn_smallmap(torch.from_numpy(d), 1.0, 50.0) is None
    got = tburn.burn(torch.from_numpy(d), torch.tensor(1.0), torch.tensor(0.3), 50.0).numpy()
    ref = np.asarray(jburn.burn(jnp.asarray(d), 1.0, jnp.float32(0.3), 50.0))
    assert np.abs(got - ref).max() <= 1e-5


def test_unknown_mode_and_gamma_raise():
    pvec = torch.zeros(61)
    with pytest.raises(ValueError):
        pe.print_encode(torch.zeros(3, 4, 4), pvec, "slide", False, True, "sRGB")
    with pytest.raises(ValueError):
        pe.print_encode(torch.zeros(3, 4, 4), pvec, "print", False, True, "Cineon")
