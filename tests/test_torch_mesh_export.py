"""``process_batch`` on a mesh with no space axis, at upstream's
batch-export settings (full size, no cache, no resize, lens correction
with no profile): each batch row's device renders its images as
``process()`` does, from a host thread of its own.

On the CPU, over meshes of repeated CPU devices: the images equal the
one-device batch (``_render`` with the key fold_in(PRNGKey(seed), i), the
path ``process()`` takes) bit for bit and in source order, a frame of
another shape included; with ``fused_decode=False`` each row renders its
images staged, and a space axis keeps the sharded staged path; a failing
image raises and leaves no thread behind; one request tree a call, one
``mesh.frame`` an image; the mosaics are all that goes up; ``count()``
loses nothing from eight threads; ``to_device`` counts a move between
devices. On the cards (``-m cuda``, two or more): the same equality on
real devices, every card running kernels, nothing copied between them on
either path of the rows, and a space axis's copies counted."""

import sys
import threading

import numpy as np
import pytest
import torch

from raw2film_tpu_torch import Processor
from raw2film_tpu_torch.io.dng import write_dng
from raw2film_tpu_torch.parallel.mesh import make_mesh
from raw2film_tpu_torch.utils import trace

STOCKS = dict(negative_film="Kodak Portra 400", print_film="Fuji Crystal Archive Maxima")
# upstream's batch export (gui.py:2472-2486): full size, no cache; no lens
# profile matches the written DNGs, so lens correction is a no-op
EXPORT = dict(half_size=False, max_scale=None, cache=False, lens_correction=True)
KW = dict(STOCKS, highlight_burn=0.3, **EXPORT)


@pytest.fixture(autouse=True)
def _recording_off():
    trace.enable(False)
    trace.reset_stats()
    yield
    trace.enable(False)
    trace.reset_stats()


def _mosaic(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = 0.04 + 0.8 * (xx / w) * (0.3 + 0.7 * yy / h) + rng.uniform(0.0, 0.05, (h, w))
    return np.clip(m, 0.0, 1.0) * 60000


def _roll(folder, shapes):
    paths = []
    for i, (h, w) in enumerate(shapes):
        p = str(folder / f"f{i}.dng")
        write_dng(p, _mosaic(h, w, i), white_level=60000, iso=100 * (i + 1))
        paths.append(p)
    return paths


SHAPES = [(48, 72)] * 4 + [(64, 96)] + [(48, 72)]  # image 4 of another shape


@pytest.fixture(scope="module")
def roll(tmp_path_factory):
    return _roll(tmp_path_factory.mktemp("roll"), SHAPES)


@pytest.fixture(scope="module")
def proc():
    return Processor(device="cpu")


def _cpu_mesh(n=4, **kw):
    return make_mesh(devices=["cpu"] * n, **kw)


def test_fused_mesh_equals_process_of_each_image(proc, roll):
    got = proc.process_batch(roll, seed=11, mesh=_cpu_mesh(), **KW)
    meta = proc.last_metadata
    want = proc.process_batch(roll, seed=11, **KW)
    assert [g.shape for g in got] == [(h, w, 3) for h, w in SHAPES]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], proc.process(roll[0], seed=11, **KW))
    assert sorted(proc._rows) == [(r, "cpu") for r in range(4)]
    # the last image's metadata, as after a one-device batch
    proc.process(roll[-1], **KW)
    assert meta == proc.last_metadata and meta
    # one image twice: its own grain key at each place
    twice = proc.process_batch([roll[0], roll[0]], seed=11, mesh=_cpu_mesh(2), **KW)
    np.testing.assert_array_equal(twice[0], got[0])
    assert not np.array_equal(twice[1], twice[0])


@pytest.mark.parametrize("how", ["fused-decode-off", "space-axis"])
def test_fused_decode_off_renders_staged_on_the_rows_and_a_space_axis_shards(proc, roll, how):
    if how == "space-axis":
        mesh, extra = _cpu_mesh(4, batch=2, space=2), {}
    else:
        mesh, extra = _cpu_mesh(2), {"fused_decode": False}
    trace.enable(ranges=False)
    got = proc.process_batch(roll[:2], seed=3, mesh=mesh, **KW, **extra)
    (tree,) = trace.requests()
    names = [s.name for s in tree]
    assert names[0] == "batch" and names.count("decode") == 2 and "prep" not in names
    assert sum((s.counts or {}).get("mesh.frames", 0) for s in tree) == 2
    frames = [s for s in tree if s.name == "mesh.frame"]
    if how == "space-axis":
        assert not frames
    else:  # each image decoded under its row's frame
        assert len(frames) == 2
        assert sorted(s.parent for s in tree if s.name == "decode") == sorted(f.id for f in frames)
        want = proc.process_batch(roll[:2], seed=3, fused_decode=False, **KW)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_a_failing_image_raises_and_joins_every_row(proc, roll, tmp_path):
    srcs = list(roll) * 2
    srcs[1] = str(tmp_path / "missing.dng")  # row 1's first image
    with pytest.raises(FileNotFoundError):
        proc.process_batch(srcs, mesh=_cpu_mesh(), **KW)
    assert not [t for t in threading.enumerate() if t.name.startswith("mesh-row")]
    assert trace.COUNTS["mesh.frames"] < len(srcs)  # the other rows stopped early
    # the Processor renders on after it
    np.testing.assert_array_equal(
        proc.process_batch(roll[:2], seed=1, mesh=_cpu_mesh(), **KW)[1],
        proc.process_batch(roll[:2], seed=1, **KW)[1],
    )


def test_one_request_tree_a_call_with_a_mesh_frame_an_image(proc, roll):
    mesh = _cpu_mesh()
    proc.process_batch(roll, seed=2, mesh=mesh, **KW)  # every row builds its bundle
    trace.enable(ranges=False)
    for _ in range(2):
        proc.process_batch(roll, seed=2, mesh=mesh, **KW)
    trees = trace.requests()
    assert len(trees) == 2
    for tree in trees:
        root = tree[0]
        assert root.name == "batch" and root.parent is None
        assert all(s.request == root.request and s.end_ns is not None for s in tree)
        assert all(root.start_ns <= s.start_ns and s.end_ns <= root.end_ns for s in tree)
        frames = [s for s in tree if s.name == "mesh.frame"]
        assert len(frames) == len(roll) and all(f.parent == root.id for f in frames)
        for f in frames:
            kids = {s.name: s for s in tree if s.parent == f.id}
            assert sorted(kids) == ["finish", "prep", "render", "render.download"]
            prep = sorted(s.name for s in tree if s.parent == kids["prep"].id)
            assert prep == ["prep.exposure", "prep.read", "prep.upload"]
        assert sum((s.counts or {}).get("mesh.frames", 0) for s in tree) == len(roll)


def test_the_mosaics_are_all_that_goes_up_and_nothing_crosses_devices(proc, roll, monkeypatch):
    mesh = _cpu_mesh()
    proc.process_batch(roll, seed=2, mesh=mesh, **KW)
    # the CPU taken for a device (as tests/test_torch_trace.py does): every
    # upload counts
    monkeypatch.setattr(trace, "on_host", lambda t: False)
    trace.enable(ranges=False)
    proc.process_batch(roll, seed=2, mesh=mesh, **KW)
    (tree,) = trace.requests()
    ups = [(s.counts or {}).get("copy.h2d.bytes", 0) for s in tree if s.name == "prep.upload"]
    assert sorted(ups) == sorted(h * w * 2 for h, w in SHAPES)
    assert not any(k.startswith("copy.d2d") for k in trace.COUNTS)


def test_count_loses_nothing_from_eight_threads():
    n, old = 4000, sys.getswitchinterval()
    trace.enable(ranges=False)
    sys.setswitchinterval(1e-6)
    try:
        with trace.stage_timer("root") as root:

            def work():
                with trace.adopted(root):
                    for _ in range(n):
                        trace.count("hits")

            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert trace.COUNTS["hits"] == 8 * n and root.counts == {"hits": 8 * n}
    assert trace.current() is None


def test_to_device_counts_a_move_between_devices(monkeypatch):
    monkeypatch.setattr(trace, "on_host", lambda t: False)  # the CPU taken for a device
    trace.enable(ranges=False)
    with trace.stage_timer("move") as move:
        out = trace.to_device(torch.zeros(2, 3), "meta")  # to another device
        trace.to_device(torch.zeros(2, 3), "cpu", copy=True)  # on its own device: no crossing
    assert out.device.type == "meta"
    assert move.counts == {"copy.d2d.n": 1, "copy.d2d.bytes": 24}


def _kernels_by_card(prof) -> dict:
    """The kernels of a ``torch.profiler`` record, counted by card index
    (copies and fills left out)."""
    by_card: dict = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and not e.name().startswith(("Memcpy", "Memset")):
            by_card[e.device_index()] = by_card.get(e.device_index(), 0) + 1
    return by_card


@pytest.mark.cuda
def test_rows_render_on_their_own_cards(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from torch.profiler import ProfilerActivity, profile

    n = torch.cuda.device_count()
    shapes = [(408, 612)] * (2 * n - 1) + [(416, 624)]
    paths = _roll(tmp_path, shapes)
    proc = Processor(device="cuda:0")
    mesh = make_mesh()
    want = proc.process_batch(paths, seed=5, **KW)
    proc.process_batch(paths, seed=5, mesh=mesh, **KW)  # every card loads its kernels and its bundle
    for i in range(n):
        torch.cuda.synchronize(i)
    trace.reset_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = proc.process_batch(paths, seed=5, mesh=mesh, **KW)
        for i in range(n):
            torch.cuda.synchronize(i)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sorted(d for _, d in proc._rows) == [f"cuda:{i}" for i in range(n)]
    by_card = _kernels_by_card(prof)
    assert sorted(by_card) == list(range(n)) and min(by_card.values()) > 0, by_card
    assert trace.COUNTS["copy.h2d.bytes"] == sum(h * w * 2 for h, w in shapes)
    assert "copy.d2d.n" not in trace.COUNTS
    # staged on the rows: each card decodes and renders its own images
    trace.reset_stats()
    staged = proc.process_batch(paths[:n], seed=5, mesh=mesh, fused_decode=False, **KW)
    for g, w in zip(staged, proc.process_batch(paths[:n], seed=5, fused_decode=False, **KW)):
        np.testing.assert_array_equal(g, w)
    assert "copy.d2d.n" not in trace.COUNTS
    # a space axis: each image decoded on card 0, its lower half's rows (and
    # halo) copied to card 1 as float32 XYZ and rendered there, and back as uint8
    trace.reset_stats()
    proc.process_batch(paths[:2], seed=5, mesh=make_mesh(2, batch=1, space=2), fused_decode=False, **KW)
    h, w = shapes[0]
    assert trace.COUNTS["copy.d2d.n"] >= 2 * 2
    assert trace.COUNTS["copy.d2d.bytes"] > 2 * 3 * (h // 2) * w * (4 + 1)
