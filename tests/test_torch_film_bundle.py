"""``pipeline/render.py::load_film_bundle`` applies every film parameter it
is given, as the JAX package's ``Processor.load_film_bundle`` and
``build_render_config`` apply them (carried across by ``convert``), and as
the port's ``Processor`` does; it refuses a key neither build reads; with
no parameters its bundle is the one it has always built from the chain
builders' defaults."""

import numpy as np
import pytest
import torch

import raw2film_tpu  # noqa: F401  (the real package, before the port's loader)
from raw2film_tpu.film.loader import load_film_stocks as jax_film_stocks
from raw2film_tpu.pipeline import params as jparams
from raw2film_tpu.pipeline.processor import Processor as JaxProcessor
from raw2film_tpu.pipeline.render import build_render_config as jax_render_config
from raw2film_tpu_torch import convert
from raw2film_tpu_torch.film import chain
from raw2film_tpu_torch.film.loader import load_film_stocks
from raw2film_tpu_torch.pipeline import params as rparams
from raw2film_tpu_torch.pipeline.processor import Processor
from raw2film_tpu_torch.pipeline.render import build_render_config, load_film_bundle, make_film_bundle

NEG, PRT = "Kodak Portra 400", "Fuji Crystal Archive Maxima"
H, W = 5472, 8208
PARAMS = {
    "sat_adjust": dict(sat_adjust=1.3),
    "color_masking": dict(color_masking=0.5),
    "gamma_func": dict(gamma_func="Display P3"),
    "exp_comp": dict(exp_comp=1.0),
    "tint": dict(tint=0.3),
    "exp_kelvin": dict(exp_kelvin=4500.0),
    "push_pull": dict(push_pull=1.0),
    "red_light": dict(red_light=0.2),
    "green_light": dict(green_light=-0.2),
    "blue_light": dict(blue_light=0.1),
}


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], tuple):
            assert len(a[k]) == len(b[k]) and all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _differs(a, b) -> bool:
    try:
        _equal(a, b)
    except AssertionError:
        return True
    return False


def _merged(params_mod, **params):
    # load_film_bundle's scene white is the chain's 6500 K, as process()'s
    merged = params_mod.merge_params(params_mod.ProfileParams(), params_mod.ImageParams())
    return {**merged, "exp_kelvin": 6500.0, **params}


def _jax(**params):
    stocks = jax_film_stocks()
    neg, prt = stocks[NEG], stocks[PRT]
    merged = _merged(jparams, **params)
    bundle, mode = JaxProcessor().load_film_bundle(neg, prt, merged)
    cfg = jax_render_config(neg, prt, mode, max(H, W) / 36.0, merged)
    return convert.bundle_from_numpy(bundle), convert.config_from_jax(cfg)


@pytest.mark.parametrize("name", list(PARAMS))
def test_each_film_parameter_is_applied_as_the_jax_processor_applies_it(name):
    p = PARAMS[name]
    bundle, cfg = load_film_bundle(NEG, PRT, H, W, device="cpu", **p)
    want_bundle, want_cfg = _jax(**p)
    _equal(bundle, want_bundle)
    assert cfg == want_cfg
    default_bundle, default_cfg = _jax()
    assert _differs(want_bundle, default_bundle) or want_cfg != default_cfg, name


def _processor(**params):
    stocks = load_film_stocks()
    neg, prt = stocks[NEG], stocks[PRT]
    merged = _merged(rparams, **params)
    bundle, mode = Processor(device="cpu").load_film_bundle(neg, prt, merged)
    return bundle, build_render_config(neg, prt, mode, max(H, W) / 36.0, merged)


@pytest.mark.parametrize("name", list(PARAMS))
def test_each_film_parameter_is_applied_as_the_processor_applies_it(name):
    p = PARAMS[name]
    bundle, cfg = load_film_bundle(NEG, PRT, H, W, device="cpu", **p)
    want_bundle, want_cfg = _processor(**p)
    _equal(bundle, want_bundle)
    assert cfg == want_cfg
    default, default_cfg = load_film_bundle(NEG, PRT, H, W, device="cpu")
    assert _differs(bundle, default) or cfg != default_cfg, name


def test_the_default_bundle_is_the_chain_builders_defaults():
    stocks = load_film_stocks()
    neg, prt = stocks[NEG], stocks[PRT]
    neg_p = chain.build_negative_params(neg)
    prt_p = chain.build_print_params(neg, prt, neg_params=neg_p)
    out_p = chain.build_output_params(neg, prt, prt_p, neg_p)
    gm = neg.grain
    d_min, *_ = neg.curve.params()
    want = make_film_bundle(
        neg_p, prt_p, out_p, halation_intensity=1.0, halation_green_factor=0.3, highlight_burn=0.3,
        d_ref_green=float(neg.d_ref[1]), grain_rms=gm.rms,
        grain_shape=(gm.peak_density, gm.width, gm.floor, float(np.min(d_min)),
                     float(np.max(neg.curve.d_max))),
        device="cpu",
    )
    bundle, cfg = load_film_bundle(device="cpu", highlight_burn=0.3)
    _equal(bundle, want)
    assert cfg.mask_identity and cfg.sat_neutral and cfg.gamma_func == "sRGB"


@pytest.mark.parametrize("key", ["zoom", "frame_width", "canvas_mode", "no_such_key"])
def test_a_key_it_cannot_apply_is_refused(key):
    with pytest.raises(TypeError, match=key):
        load_film_bundle(device="cpu", **{key: 1.0})
