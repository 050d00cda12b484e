"""The CLI's export function (``cli.export_files``) on the CPU, on a small
seeded roll at the CLI's defaults (the staged half-size path, the decode
pool): its frames against the benchmark's plain reference
(``portbench/ref/staged.py``) within the limits of the ``export-24mp-cli``
cell, on both halation tiers below /4; one traced call is one ``roll``
request tree holding the pool's reads; ``main`` exports through it."""

import json
import os

import numpy as np
import pytest

from portbench import inputs
from portbench.compare import CodeGap
from portbench.ref import staged
from portbench.ref.chain import Ref
from raw2film_tpu_torch import cli
from raw2film_tpu_torch.pipeline.processor import Processor
from raw2film_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 204, 306  # a half-size render of 102 x 153: the 24 MP frame's 83.3 px/mm below
N = 3


def _load(path):
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


CONFIG = _load("portbench/configs/portra400-fcam-24mp-cli.json")
LIMITS = _load("portbench/traffic/cli-roll-export.json")["limits"]
FRAME = CONFIG["frame"]
PX_PER_MM = FRAME["width"] / CONFIG["settings"]["frame_width"]  # the full 24 MP frame's
FLAGS = ["--frame-width", str(W / PX_PER_MM), "--frame-height", str(H / PX_PER_MM)]


@pytest.fixture(scope="module")
def roll(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("roll"))
    gen = inputs.generator(2**33 + 21, "cpu")
    mosaics = inputs.mosaics(N, H, W, FRAME["black_level"], FRAME["white_level"], gen, "cpu")
    paths = inputs.roll(folder, mosaics, FRAME["black_level"], FRAME["white_level"], FRAME["color_matrix"])
    return folder, paths, mosaics


@pytest.fixture
def recording():
    trace.reset_stats()
    trace.enable(ranges=False, events=False)
    yield
    trace.enable(False)
    trace.reset_stats()


def _export(folder, paths, *flags):
    frames = {}

    def keep(image, src):
        frames[src] = image
        return src

    args = cli.parse_args([folder, "--jobs", "2", *FLAGS, *flags])
    results = cli.export_files(args, paths, processor=Processor(device="cpu"), export=keep)
    assert [r.src for r in results] == paths and all(r.ok for r in results), results
    return frames


@pytest.mark.parametrize("halation_size", [1.0, 0.5])  # glow 20.8 px (SVD ranks), 10.4 px (dense)
def test_export_files_matches_the_staged_reference(roll, halation_size):
    folder, paths, mosaics = roll
    frames = _export(folder, paths, "--halation-size", str(halation_size))
    settings = {**CONFIG["settings"], "halation_size": halation_size,
                "frame_width": W / PX_PER_MM, "frame_height": H / PX_PER_MM}
    norm = np.asarray([FRAME["black_level"], 1.0 / (FRAME["white_level"] - FRAME["black_level"])], np.float32)
    gap = CodeGap()
    for path, mosaic in zip(paths, mosaics):
        want = staged.frame(Ref(), mosaic, norm, inputs.cam_to_xyz(FRAME["color_matrix"]), inputs.written_meta(),
                            settings, 0, "cpu")
        assert frames[path].shape == (H // 2, W // 2, 3)
        gap.add(frames[path], want.movedim(0, -1))
    got = gap.numbers()
    assert all(got[k] <= LIMITS[k] for k in LIMITS), got


def test_a_traced_call_is_one_roll_tree_with_the_pools_reads(roll, recording):
    folder, paths, _ = roll
    _export(folder, paths)
    (tree,) = trace.requests()
    root = tree[0]
    assert root.name == "roll" and root.parent is None and root.end_ns is not None
    reads = [s for s in tree if s.name == "read"]
    assert len(reads) == N and all(s.parent == root.id for s in reads)
    assert trace.stage_stats()["read"]["count"] == N  # no read outside the tree
    assert root.counts == {"roll.frames": N}
    assert [s.parent for s in tree if s.name == "roll.wait"] == [root.id] * (N + 1)  # the last get is the end
    assert sum(s.name == "process" for s in tree) == N


def test_recording_off_the_roll_records_nothing(roll):
    trace.reset_stats()
    folder, paths, _ = roll
    _export(folder, paths[:1])
    assert trace.requests() == [] and trace.stage_stats() == {}


def test_main_exports_through_export_files(roll, tmp_path, monkeypatch):
    folder, paths, _ = roll
    calls = []
    export_files = cli.export_files

    def spy(args, files, **kw):
        calls.append((list(files), kw))
        return export_files(args, files, **kw)

    monkeypatch.setattr(cli, "export_files", spy)
    argv = [folder, "--jobs", "2", *FLAGS, "--device", "cpu"]
    assert cli.main([*argv, "-o", str(tmp_path / "main")]) == 0
    assert calls == [(paths, {})]
    export_files(cli.parse_args([*argv, "-o", str(tmp_path / "direct")]), paths)
    names = sorted(os.listdir(tmp_path / "main"))
    assert names == sorted(os.path.basename(p).replace(".dng", ".jpg") for p in paths)
    for name in names:
        with open(tmp_path / "main" / name, "rb") as a, open(tmp_path / "direct" / name, "rb") as b:
            assert a.read() == b.read()
