"""The 45 MP look with halation off (``portbench/configs/
portra400-fcam-45mp-nohal.json``) on the CPU, at 408 x 612 with the full
frame's 228 px/mm: the program's render, through
``Processor.load_film_bundle`` and ``render_chain_from_mosaic`` as the
``render-45mp-nohal`` cell runs it, equals the benchmark's plain reference
(``portbench/ref/chain.py::Ref.render_mosaic``, whose development is
``Ref.develop`` with halation off) bit for bit, as the plain versions do at
this size; a development computed in bfloat16 fails the cell's limits."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench import settings as st
from portbench.compare import CodeGap
from portbench.ref import process as rproc
from portbench.ref.chain import Ref
from raw2film_tpu_torch.film.loader import load_film_stocks
from raw2film_tpu_torch.pipeline import render
from raw2film_tpu_torch.pipeline.processor import Processor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 408, 612
SEEDS = [2**33 + 3, 2**31 + 77]


def _load(path):
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


CONFIG = _load("portbench/configs/portra400-fcam-45mp-nohal.json")
LIMITS = _load("portbench/traffic/resident-render.json")["limits"]
FRAME = CONFIG["frame"]
SCALE = st.scale(CONFIG)  # the full frame's pixels per mm
SETTINGS = {**CONFIG["settings"], "frame_height": H / SCALE, "frame_width": W / SCALE}
NORM = np.asarray([FRAME["black_level"], 1.0 / (FRAME["white_level"] - FRAME["black_level"])], np.float32)
CAM = inputs.cam_to_xyz(FRAME["color_matrix"])


def _mosaics(seed):
    gen = inputs.generator(seed, "cpu")
    return inputs.mosaics(2, H, W, FRAME["black_level"], FRAME["white_level"], gen, "cpu")


def _program(mosaics, grain_seeds):
    stocks = load_film_stocks()
    neg, prt = stocks[SETTINGS["negative_film"]], stocks[SETTINGS["print_film"]]
    merged = st.merged(SETTINGS)
    bundle, mode = Processor(device="cpu").load_film_bundle(neg, prt, merged)
    cfg = render.build_render_config(neg, prt, mode, SCALE, merged)
    assert not cfg.halation and cfg.mask_identity
    return [render.render_chain_from_mosaic(m, CAM, bundle, cfg, s, FRAME["pattern"], 1.0, None, NORM,
                                            device="cpu") for m, s in zip(mosaics, grain_seeds)]


def _gap(mosaics, grain_seeds, got):
    film = rproc.film_params(SETTINGS, "cpu")
    look = rproc.look(SETTINGS, film, SCALE)
    assert not look["halation"]
    gap = CodeGap()
    for m, s, g in zip(mosaics, grain_seeds, got):
        gap.add(g, Ref().render_mosaic(m, CAM, 1.0, NORM, FRAME["pattern"], film, look, s))
    return gap.numbers()


@pytest.mark.parametrize("seed", SEEDS)
def test_the_nohal_render_equals_the_reference(seed):
    mosaics, grain_seeds = _mosaics(seed), st.seeds(seed, 2)
    got = _gap(mosaics, grain_seeds, _program(mosaics, grain_seeds))
    assert got == {"codes_off_pct": 0.0, "worst_tile_off_pct": 0.0}


def _bf16_develop(develop):
    """``develop`` computed in bfloat16: the exposure and the film's
    development parameters rounded to it, every operation in it."""

    def low(ep, bundle):
        b = dict(bundle)
        for k in ("flare", "d_min", "mask"):
            b[k] = bundle[k].to(torch.bfloat16)
        b["neg_curve"] = tuple(c.to(torch.bfloat16) for c in bundle["neg_curve"])
        d = develop(ep.to(torch.bfloat16), b)
        assert d.dtype == torch.bfloat16
        return d.to(torch.float32)

    return low


def test_a_bfloat16_development_fails_the_cells_limits(monkeypatch):
    seed = SEEDS[0]
    mosaics, grain_seeds = _mosaics(seed), st.seeds(seed, 2)
    monkeypatch.setattr(render, "_develop", _bf16_develop(render._develop))
    got = _gap(mosaics, grain_seeds, _program(mosaics, grain_seeds))
    assert got["codes_off_pct"] > LIMITS["codes_off_pct"], got
