"""The CLI's default roll export (``export-24mp-cli``) on the CPU at a small
frame of the same pixels per mm: the reference (``ref/staged.py``) equals
the program's plain versions bit for bit once the program's glow is the
dense kernel too, on both halation tiers below /4; planted faults and the
TF32 control are not correct; a traced run reports the cell's seven
program metrics; ``cli_roll_export.argv`` is the folder and ``--jobs`` alone."""

import json
import os
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import ROOT, run_small, small
from portbench import bench

CELL = "export-24mp-cli"
SPEC = bench.load_spec(ROOT)
SEVEN = ["read_ms.cli", "wait_ms.cli", "decode_ms.cli", "geometry_ms.cli", "download_ms.cli",
         "h2d_mb_per_frame.cli", "d2h_mb_per_frame.cli"]
# halation_size -> the glow's size in px at the half-size frame's 83.3 px/mm
TIERS = {1.0: "svd", 0.5: "dense"}


@pytest.fixture(autouse=True)
def _recording_off():
    from raw2film_tpu_torch.utils import trace

    yield
    trace.enable(False)
    trace.reset_stats()


def run(seconds=0.3, control=False, **settings):
    """A run of the cell at the small frame, its settings changed."""
    resolved = small(bench.resolve(SPEC, CELL))
    resolved["config"]["settings"].update(settings)
    return bench.run_cell(resolved, 2**33 + 12345, seconds, False, time.perf_counter(), torch.device("cpu"),
                          control=control)


def dense_glow(img, scale, halation_size):
    """A plain dense halation glow: the exponential kernel over reflect-101
    padding (``F.pad``), tap by tap in row-major order, zero taps skipped."""
    from raw2film_tpu_torch.ops import halation

    k = halation.exponential_blur_kernel(scale / 4.0 * halation_size).astype(np.float32)
    r = k.shape[0] // 2
    h, w = img.shape[-2:]
    p = F.pad(img[None], (r, r, r, r), mode="reflect")[0]
    out = None
    for i in range(k.shape[0]):
        for j in range(k.shape[1]):
            if k[i, j] != 0.0:
                term = float(k[i, j]) * p[:, i : i + h, j : j + w]
                out = term if out is None else out + term
    return out


@pytest.mark.parametrize("halation_size", sorted(TIERS))
def test_the_reference_equals_the_plain_versions_with_a_dense_glow(halation_size, monkeypatch):
    from raw2film_tpu_torch.ops import halation

    resolved = small(bench.resolve(SPEC, CELL))
    scale = resolved["config"]["frame"]["width"] / 2 / resolved["config"]["settings"]["frame_width"]
    size = scale / 4.0 * halation_size
    assert (size <= 12.0) == (TIERS[halation_size] == "dense") and size <= 40.0
    calls = []
    monkeypatch.setattr(halation, "halation_blur", lambda *a: calls.append(a[1:]) or dense_glow(*a))
    res = run(halation_size=halation_size)
    assert calls and res["failed"] == 0
    assert all(c["value"] == 0.0 for c in res["checks"].values()), res["checks"]


def test_the_programs_svd_glow_is_within_the_limits():
    res = run()
    assert res["correct"] and res["failed"] == 0, res["checks"]


def _no_gain(src, half_size=True, device=None):
    from raw2film_tpu_torch.io import dng, raw

    parsed = src if isinstance(src, dng.RawImage) else dng.read_raw(str(src))
    return raw.decode_raw(parsed, half_size=half_size, device=device), parsed.metadata


def _develop_unmasked(ep, bundle):
    from raw2film_tpu_torch.ops import halation

    return halation.develop_density(ep, halation.develop_vector(bundle))


@pytest.mark.parametrize("fault", ["gain_dropped", "halation_dropped", "unmasked"])
def test_planted_faults_are_not_correct(fault, monkeypatch):
    """The decode's exposure gain dropped before the geometry round trip;
    the halation stage dropped; the development without the film's masking
    (at color_masking 0.5: at 1.0, upstream's default, the mask is the
    identity and dropping it changes nothing but the rounding of D - Dmin +
    Dmin)."""
    import dataclasses

    from raw2film_tpu_torch.pipeline import processor, render

    settings = {}
    if fault == "gain_dropped":
        monkeypatch.setattr(processor, "raw_to_linear", _no_gain)
    elif fault == "halation_dropped":
        build = processor.build_render_config
        monkeypatch.setattr(processor, "build_render_config",
                            lambda *a, **k: dataclasses.replace(build(*a, **k), halation=False))
    else:
        settings["color_masking"] = 0.5
        assert run(**settings)["correct"]  # the sound program at that mask
        monkeypatch.setattr(render, "_develop", _develop_unmasked)
    res = run(**settings)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert not res["correct"], (fault, res["checks"])


def test_the_tf32_control_is_not_correct():
    res = run(control=True)
    assert not res["correct"]
    assert res["checks"]["codes_off_pct"]["value"] > res["checks"]["codes_off_pct"]["limit"]


def test_a_traced_run_reports_the_seven_metrics():
    res = run_small(CELL, trace=True)
    assert res["correct"], res["checks"]
    values = {m: res["metrics"][m]["value"] for m in SEVEN}
    assert all(values[m] > 0.0 for m in SEVEN if m.endswith("_ms.cli"))
    # nothing crosses between the host and a device on the CPU
    assert values["h2d_mb_per_frame.cli"] == values["d2h_mb_per_frame.cli"] == 0.0
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    assert all(entries[m]["workloads"] == [CELL] and entries[m]["moves"] == "export_ms_per_frame" for m in SEVEN)
    assert CELL in entries["device_idle_share.export"]["workloads"]


def test_the_argv_is_the_folder_and_jobs_and_the_config_upstreams_defaults():
    from raw2film_tpu_torch.pipeline.params import merge_params

    resolved = bench.resolve(SPEC, CELL)
    config, traffic = resolved["config"], resolved["traffic"]
    driver = bench.load_driver(traffic["driver"])
    assert driver.argv("/roll", config["settings"], traffic["jobs"]) == ["/roll", "--jobs", "4"]
    assert driver.argv("/roll", {**config["settings"], "halation_size": 0.5}, 4)[3:] == ["--halation-size", "0.5"]
    assert config["settings"] == merge_params()
    configs = {c["name"]: c for c in SPEC["configs"]}
    with open(os.path.join(ROOT, configs["vision3-500t-2383-24mp"]["file"])) as f:
        assert config["frame"] == json.load(f)["frame"]
    assert config["roll_frames"] == 24 and resolved["cell"]["chips"] == 1
