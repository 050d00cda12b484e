"""Shared pieces of the benchmark's CPU tests: a cell resolved at a small
frame that keeps the cell's paths (the same pixels per mm, so the same
halation tier and MTF taps, and a frame wide enough for the burn's small
map), and a run of it on the CPU with the check."""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import bench  # noqa: E402
from portbench import settings as st  # noqa: E402

SMALL = (408, 612)  # the burn's factor ceil(408 / 50) = 9 keeps its small-map path


def small(resolved: dict, hw=SMALL) -> dict:
    conf = resolved["config"]
    scale = st.scale(conf)
    conf["frame"]["height"], conf["frame"]["width"] = hw
    conf["settings"]["frame_height"], conf["settings"]["frame_width"] = hw[0] / scale, hw[1] / scale
    return resolved


def run_small(cell: str, seconds: float = 0.3, trace: bool = False, control: bool = False,
              seed: int = 2**33 + 12345, bench_dir: str = bench.HERE, spec=None) -> dict:
    import torch

    resolved = small(bench.resolve(spec or bench.load_spec(ROOT), cell, bench_dir))
    return bench.run_cell(resolved, seed, seconds, trace, time.perf_counter(), torch.device("cpu"),
                          bench_dir=bench_dir, control=control)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs only on an NVIDIA GPU")
    return torch.device("cuda", 0)
