"""Whole runs of each cell on the CPU at a small frame (the program's plain
versions, which the card's kernels are held to): the reference agrees with
the program; the control, and each fault a cell can have planted under
the timed path, come out not correct; a run refuses to start without a
card; a stall in the window moves the rate and the tail."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, run_small
from portbench import bench

CELLS = [w["name"] for w in bench.load_spec(ROOT)["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program_on_the_cpu(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["value"] == 0.0 for c in res["checks"].values()), res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(cell):
    res = run_small(cell, control=True)
    assert not res["correct"], res["checks"]
    assert res["checks"]["codes_off_pct"]["value"] > res["checks"]["codes_off_pct"]["limit"]


def _faulty(kind):
    """A wrapper that breaks what a request answers: ``unchanged`` answers
    every request with the first one's answer; ``half`` leaves the bottom
    half of the rows unrendered (zero); ``altered`` adds 1 to every code."""
    first = []

    def wrap(fn):
        def broken(*a, **kw):
            out = fn(*a, **kw)
            img = out[0] if isinstance(out, tuple) else out
            if kind == "unchanged":
                if not first:
                    first.append(img.copy() if isinstance(img, np.ndarray) else img.clone())
                img = first[0]
            elif kind == "half":
                img = img.copy() if isinstance(img, np.ndarray) else img.clone()
                rows = img.shape[0] if isinstance(img, np.ndarray) else img.shape[-2]
                if isinstance(img, np.ndarray):
                    img[rows // 2 :] = 0
                else:
                    img[..., rows // 2 :, :] = 0
            else:
                img = img + 1 if isinstance(img, torch.Tensor) else (img + np.uint8(1))
            return img
        return broken

    return wrap


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_under_the_timed_path_are_not_correct(cell, kind, monkeypatch):
    from raw2film_tpu_torch.pipeline import processor, render

    wrap = _faulty(kind)
    if bench.resolve(bench.load_spec(ROOT), cell)["traffic"]["driver"] == "resident_render":
        monkeypatch.setattr(render, "render_chain_from_mosaic", wrap(render.render_chain_from_mosaic))
    else:
        monkeypatch.setattr(processor.Processor, "process", wrap(processor.Processor.process))
    res = run_small(cell, seconds=0.6)
    assert res["attempted"] >= 2
    assert not res["correct"], (kind, res["checks"])


def test_without_a_card_a_run_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", str(2**32 + 7),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


class _Steps:
    """A fake driver: each request takes ``dt`` s, every ``every``-th ``stall`` s."""

    def __init__(self, dt, stall=0.0, every=10**9):
        self.dt, self.stall, self.every, self.i = dt, stall, every, 0

    def step(self):
        self.i += 1
        time.sleep(self.stall if self.i % self.every == 0 else self.dt)
        return {"mp": 1.0, "frames": 1}


def _window(driver, seconds=0.6):
    run = bench.Run({"chips": 1}, {}, {}, "cpu")
    bench.window(driver, run, seconds)
    return run


def test_a_stall_moves_the_rate_and_the_tail_over_the_whole_window():
    rate, p95, per_frame = (bench.load_metric(m) for m in ("render_mp_per_s", "preview_ms_p95.preview", "export_ms_per_frame"))
    calm = _window(_Steps(0.005))
    stalled = _window(_Steps(0.005, stall=0.05, every=8))
    assert rate.read(stalled) < 0.75 * rate.read(calm)
    assert per_frame.read(stalled) > 1.3 * per_frame.read(calm)
    assert p95.read(stalled) > 5 * p95.read(calm)
    # a request still running when the time is up counts, and so does its time
    late = _window(_Steps(0.3), seconds=0.35)
    assert late.attempted == 2 and late.window_s >= 0.6
    assert rate.read(late) == pytest.approx(2.0 / late.window_s)


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", str(2**32 + 9),
                          "--seconds", "2", "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert os.path.isdir(os.path.join(ROOT, "raw2film_tpu_torch", "_build"))
