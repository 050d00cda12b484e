"""The readers of the program's own spans and counters (``portbench/
program.py``): a traced run of each cell on the CPU reports every one the
cell lists (the copies read 0, since nothing crosses to a device there); an
untraced run leaves the program's recording off, since only per-layer
readers turn it on and only traced runs load them; and a program without
the recorder gives nothing and raises nothing."""

import json
import subprocess
import sys
import types

import pytest

from conftest import ROOT, run_small
from portbench import bench, program

SPEC = bench.load_spec(ROOT)
TEN = ("exposure_ms.export", "enqueue_ms.render", "bundle_ms.preview", "cast_ms.preview",
       "download_ms.export", "download_ms.preview", "h2d_mb_per_frame.export",
       "h2d_mb_per_frame.preview", "d2h_mb_per_frame.export", "d2h_mb_per_frame.preview")
NEW = {m["name"]: m for m in SPEC["per_layer"] if m["name"] in TEN}
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture(autouse=True)
def _recording_off():
    from raw2film_tpu_torch.utils import trace

    yield
    trace.enable(False)
    trace.reset_stats()


def test_the_ten_readers_read_the_program():
    """Each is in BENCHMARK.json with a list of cells, and its reader reads
    through ``portbench/program.py`` (loading it turns recording on)."""
    from raw2film_tpu_torch.utils import trace

    assert sorted(NEW) == sorted(TEN)
    for name, m in NEW.items():
        assert m["source"] in ("program_span", "program_counter") and m["workloads"], m
        assert bench.load_metric(name).program is program
    assert trace.recording()


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_every_program_metric_of_its_cell(cell):
    res = run_small(cell, trace=True)
    assert res["correct"], res["checks"]
    mine = [n for n, m in NEW.items() if cell in m["workloads"]]
    assert mine
    for name in mine:
        value = res["metrics"][name]["value"]
        if "_mb_per_frame." in name:
            assert value == 0.0, (name, value)
        else:
            assert value > 0.0, (name, value)


def test_an_untraced_run_leaves_recording_off():
    code = (
        "import json, sys; sys.path[:0] = [%r, %r]\n"
        "from conftest import run_small\n"
        "from raw2film_tpu_torch.utils import trace\n"
        "res = run_small('preview-24mp')\n"
        "print(json.dumps([trace.recording(), len(trace.requests()), sorted(res['metrics'])]))\n"
    ) % (ROOT, f"{ROOT}/portbench/tests")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    recording, n_spans, metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert recording is False and n_spans == 0
    assert metrics == ["preview_ms_p50", "setup_s"]


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    import raw2film_tpu_torch.utils as utils

    bare = types.ModuleType("raw2film_tpu_torch.utils.trace")  # the recorder's earlier form: no log
    bare.stage_timer = lambda name: None
    monkeypatch.setitem(sys.modules, "raw2film_tpu_torch.utils.trace", bare)
    monkeypatch.setattr(utils, "trace", bare, raising=False)
    run = bench.Run({"chips": 1}, {}, {}, "cpu")
    run.latencies_s = [0.1, 0.1]
    program.record()
    for name in NEW:
        assert bench.load_metric(name).read(run) is None, name
