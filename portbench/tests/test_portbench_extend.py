"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files and entries only: in a copy of the
benchmark, the harness runs the new cell, with its new metric, without a
change to any file that was there."""

import hashlib
import json
import os
import shutil

from conftest import ROOT, run_small
from portbench import bench


def _digests(folder):
    out = {}
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if "__pycache__" not in dirpath:
                path = os.path.join(dirpath, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, folder)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_and_entries_run_unedited(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(bench.HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(copy)
    spec = bench.load_spec(ROOT)

    conf = json.loads((copy / "configs" / "vision3-500t-2383-24mp.json").read_text())
    conf.update(name="vision3-250d-2383-24mp", settings={**conf["settings"], "negative_film": "Kodak Vision3 250D"})
    (copy / "configs" / "vision3-250d-2383-24mp.json").write_text(json.dumps(conf))
    mix = json.loads((copy / "traffic" / "resident-render.json").read_text())
    mix["frames"] = 2
    (copy / "traffic" / "resident-pair.json").write_text(json.dumps(mix))
    (copy / "metrics" / "frames_rendered.pair.py").write_text(
        '"""Frames rendered in the window, from the driver\'s units."""\n\n\n'
        "def read(run):\n    return run.latencies_s and len(run.latencies_s)\n"
    )
    spec["configs"].append({"name": conf["name"], "source": conf["source"],
                            "file": "portbench/configs/vision3-250d-2383-24mp.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "render-250d", "config": conf["name"], "traffic": "resident-pair",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "render_mp_per_s":
            m["workloads"].append("render-250d")
    spec["per_layer"].append({"name": "frames_rendered.pair", "unit": "frames", "better": "higher",
                              "source": "host_clock", "layer": "entry", "moves": "render_mp_per_s",
                              "workloads": ["render-250d"]})

    res = run_small("render-250d", bench_dir=str(copy), spec=spec)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"render_mp_per_s", "setup_s"}
    traced = run_small("render-250d", trace=True, bench_dir=str(copy), spec=spec)
    assert traced["correct"] and traced["metrics"]["frames_rendered.pair"]["value"] >= 1
    after = _digests(copy)
    assert {k: v for k, v in after.items() if k in before} == before
