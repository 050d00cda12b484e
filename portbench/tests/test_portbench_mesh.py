"""The four-card roll export (``roll-export-4chips``) on the CPU, on a
virtual mesh of the CPU repeated four times: the cell is correct, its
traced run reports its per-layer metrics, the TF32 control and planted
faults (two frames' results swapped in the mesh path; one batch row's
results altered) are not correct, the check keeps a frame of every batch
row, and its configuration keeps the frame and the look of the one-card
export's."""

import json
import os

import pytest

from conftest import ROOT, run_small
from portbench import bench

CELL = "roll-export-4chips"
SPEC = bench.load_spec(ROOT)
MESH_METRICS = ["frames_in_flight.mesh", "read_ms.mesh", "prep_ms.mesh", "h2d_mb_per_frame.mesh",
                "d2d_mb_per_frame.mesh", "download_ms.mesh", "d2h_mb_per_frame.mesh", "exposure_ms.mesh"]


@pytest.fixture(autouse=True)
def _recording_off():
    from raw2film_tpu_torch.utils import trace

    yield
    trace.enable(False)
    trace.reset_stats()


def test_the_cell_runs_small_and_is_correct():
    res = run_small(CELL)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert all(c["value"] == 0.0 for c in res["checks"].values()), res["checks"]
    assert set(res["metrics"]) == {"export_ms_per_frame", "setup_s"}
    assert res["device"]["count"] == 4


def test_a_traced_run_reports_the_mesh_metrics():
    res = run_small(CELL, trace=True)
    assert res["correct"], res["checks"]
    values = {m: res["metrics"][m]["value"] for m in MESH_METRICS}
    assert 0.0 < values["frames_in_flight.mesh"] <= 4.0 + 1e-9
    assert all(values[m] > 0.0 for m in ("read_ms.mesh", "prep_ms.mesh", "download_ms.mesh", "exposure_ms.mesh"))
    # nothing crosses between the host and a device on the CPU
    assert all(values[m] == 0.0 for m in MESH_METRICS if "_mb_per_frame." in m)
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    assert all(entries[m]["workloads"] == [CELL] and entries[m]["moves"] == "export_ms_per_frame"
               for m in MESH_METRICS)


def test_the_tf32_control_is_not_correct():
    res = run_small(CELL, control=True)
    assert not res["correct"]
    assert res["checks"]["codes_off_pct"]["value"] > res["checks"]["codes_off_pct"]["limit"]


def test_two_frames_swapped_in_the_mesh_path_are_not_correct(monkeypatch):
    from raw2film_tpu_torch.pipeline import processor

    seed = 2**33 + 12345  # run_small's
    config = bench.resolve(SPEC, CELL)["config"]
    traffic = bench.resolve(SPEC, CELL)["traffic"]
    driver = bench.load_driver(traffic["driver"])
    j = driver.checked_frames(seed, config["roll_frames"], config["layout"]["mesh"]["batch"])[0]
    other = (j + 1) % config["roll_frames"]
    render_rows = processor.Processor._render_rows

    def swapped(self, *a, **kw):
        out = render_rows(self, *a, **kw)
        if len(out) == config["roll_frames"]:  # the timed calls, not the warm-up
            out[j], out[other] = out[other], out[j]
        return out

    monkeypatch.setattr(processor.Processor, "_render_rows", swapped)
    res = run_small(CELL, seed=seed)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert not res["correct"], res["checks"]


def test_the_check_keeps_a_frame_of_every_batch_row():
    config = bench.resolve(SPEC, CELL)["config"]
    driver = bench.load_driver(bench.resolve(SPEC, CELL)["traffic"]["driver"])
    n, rows = config["roll_frames"], config["layout"]["mesh"]["batch"]
    drawn = set()
    for seed in range(2**31, 2**31 + 500):
        frames = driver.checked_frames(seed, n, rows)
        assert [j % rows for j in frames] == list(range(rows))
        drawn.update(frames)
    assert drawn == set(range(n))


@pytest.mark.parametrize("seed", [2**33 + 12345, 2**33 + 12349, 2**31])
def test_one_batch_row_altered_is_not_correct(seed, monkeypatch):
    """A fault on one card alone: every answer of batch row 3 off by a code
    (the last two seeds drew no frame of row 3 when the check drew 4 frames
    of the 12 at random)."""
    from raw2film_tpu_torch.pipeline import processor

    config = bench.resolve(SPEC, CELL)["config"]
    rows = config["layout"]["mesh"]["batch"]
    render_rows = processor.Processor._render_rows

    def row_altered(self, *a, **kw):
        out = render_rows(self, *a, **kw)
        return [img + 1 if j % rows == rows - 1 else img for j, img in enumerate(out)]

    monkeypatch.setattr(processor.Processor, "_render_rows", row_altered)
    res = run_small(CELL, seed=seed)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert not res["correct"], res["checks"]


def test_the_config_keeps_the_one_card_exports_frame_and_look():
    configs = {c["name"]: c for c in SPEC["configs"]}

    def load(name):
        with open(os.path.join(ROOT, configs[name]["file"])) as f:
            return json.load(f)

    four, one = load("portra400-fcam-45mp-4cards"), load("portra400-fcam-45mp")
    assert four["frame"] == one["frame"] and four["settings"] == one["settings"]
    assert four["layout"]["mesh"] == {"batch": 4, "space": 1} and four["layout"]["cards"] == 4
    cell = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert cell["chips"] == four["layout"]["cards"] and four["reduced"] == ["roll_frames"]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert CELL in e2e["export_ms_per_frame"]["workloads"]
