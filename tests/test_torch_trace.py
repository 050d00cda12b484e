"""The port's recorder, ``raw2film_tpu_torch/utils/trace.py``: spans nest
into request trees, a worker thread's span starts its own request, the
stage statistics cover every call since the reset, recording off leaves no
trace, recording on gives ``process()`` one tree of the layers it crossed,
the copy helpers count only crossings between the host and a device, the
launch counts are the ``launch.<kernel>`` counters, and each render
counts the route its density took (``develop.plain`` or ``develop.fused``)
with ``render.develop``'s device the exposure. On the card
(``-m cuda``), the copy counters of a fused ``process()`` match its bytes
and K15 runs once; a cached repeat copies nothing up; a copy down of 1 MiB
or more lands in page-locked memory, equal to ``.cpu()``'s; the plain
development's span carries an event pair.

Every test leaves recording off and the log empty (``_recording_off``)."""

import threading

import numpy as np
import pytest
import torch

from raw2film_tpu_torch import PreviewEngine, Processor
from raw2film_tpu_torch.io.dng import write_dng
from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.utils import trace

STOCKS = dict(negative_film="Kodak Portra 400", print_film="Fuji Crystal Archive Maxima")
FUSED = dict(half_size=False, max_scale=None)  # full size, no resize: the fused path


@pytest.fixture(autouse=True)
def _recording_off():
    trace.enable(False)
    trace.reset_stats()
    yield
    trace.enable(False)
    trace.reset_stats()


def _mosaic(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = 0.04 + 0.8 * (xx / w) * (0.3 + 0.7 * yy / h) + rng.uniform(0.0, 0.05, (h, w))
    return np.clip(m, 0.0, 1.0) * 60000


@pytest.fixture(scope="module")
def dng(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("trace") / "t.dng")
    write_dng(p, _mosaic(64, 96), white_level=60000)
    return p


def _names(spans):
    return [s.name for s in spans]


def test_spans_nest_with_parent_and_request_ids():
    trace.enable(ranges=False)
    with trace.stage_timer("a") as a:
        with trace.stage_timer("b") as b:
            with trace.stage_timer("c", device=torch.zeros(1)) as c:
                trace.count("n", 2)
            trace.count("n")
    with trace.stage_timer("d") as d:
        pass
    assert (a.parent, b.parent, c.parent, d.parent) == (None, a.id, b.id, None)
    assert a.request == b.request == c.request != d.request
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= a.end_ns
    assert c.counts == {"n": 2} and b.counts == {"n": 1} and a.counts is None
    assert c.events is None and c.device_ms() is None  # a CPU tensor records no event pair
    assert trace.COUNTS["n"] == 3
    assert [_names(r) for r in trace.requests()] == [["a", "b", "c"], ["d"]]
    assert set(trace.stage_stats()) == {"a", "b", "c", "d"}


def test_a_span_on_the_preview_worker_starts_its_own_request(dng):
    """The engine's turn is a request of its own, though the thread that
    asked for it has a span open; the Processor's spans belong to it."""
    trace.enable(ranges=False)
    got = threading.Event()
    engine = PreviewEngine(Processor(device="cpu"), on_frame=lambda img, hist: got.set(),
                           on_error=lambda e: got.set())
    try:
        with trace.stage_timer("caller") as caller:
            engine.request(dng, **STOCKS, seed=1)
            assert got.wait(300)
    finally:
        engine.close()
    trees = {r[0].name: r for r in trace.requests()}
    assert set(trees) == {"caller", "preview.frame"}
    frame = trees["preview.frame"]
    assert frame[0].parent is None and frame[0].request != caller.request
    assert {"preview.wait", "preview.render", "process", "render", "preview.histogram"} <= set(_names(frame))
    wait = next(s for s in frame if s.name == "preview.wait")
    assert wait.parent == frame[0].id and wait.start_ns == frame[0].start_ns
    assert _names(trees["caller"]) == ["caller"]


def test_a_device_span_records_an_event_pair_unless_events_are_off(monkeypatch):
    """On a CUDA tensor a span records an event at each end on its stream,
    read only when asked; ``enable(events=False)`` keeps it to host time."""

    class Event:
        def __init__(self):
            self.on = []

        def record(self, stream):
            self.on.append(stream)

        def query(self):
            return True

        def elapsed_time(self, end):
            return 2.5

    class OnCuda:  # stands for a CUDA tensor
        is_cuda = True

    monkeypatch.setattr(trace, "_event_pair", lambda t: ("stream", (Event(), Event())))
    trace.enable(ranges=False)
    with trace.stage_timer("kernel.x", device=OnCuda()) as k:
        assert k.events[0].on == ["stream"] and k.events[1].on == []
    assert k.events[1].on == ["stream"] and k.device_ms() == 2.5
    assert trace.stage_stats()["kernel.x"]["device_mean_ms"] == 2.5
    trace.enable(ranges=False, events=False)
    with trace.stage_timer("kernel.y", device=OnCuda()) as k:
        pass
    assert k.events is None and k.device_ms() is None and k.end_ns is not None


def test_stage_stats_cover_every_call_since_the_reset(monkeypatch):
    """100 calls of 1, 2, ..., 100 ms: the count is 100 and the mean 50.5
    ms, over all of them (not the last 64)."""
    clock = iter(t for k in range(1, 101) for t in (0, k * 1_000_000))
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: next(clock))
    trace.enable(ranges=False)
    for _ in range(100):
        with trace.stage_timer("step"):
            pass
    st = trace.stage_stats()["step"]
    assert st["count"] == 100
    assert st["mean_ms"] == pytest.approx(50.5) and st["last_ms"] == pytest.approx(100.0)
    trace.reset_stats()
    assert trace.stage_stats() == {} and trace.requests() == []


def test_recording_off_leaves_no_trace(dng, monkeypatch):
    entered = []
    monkeypatch.setattr(trace, "record_function", lambda name: entered.append(name))
    assert not trace.recording()
    assert trace.stage_timer("x") is trace.stage_timer("y", device=torch.zeros(1))  # one shared context
    Processor(device="cpu").process(dng, **STOCKS, seed=1, **FUSED)
    assert trace.requests() == [] and trace.stage_stats() == {} and entered == []
    trace.count("x")
    assert trace.COUNTS["x"] == 1  # the running totals count with recording off


def test_recording_on_enters_profiler_ranges(monkeypatch):
    entered = []

    class Range:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trace, "record_function", Range)
    trace.enable()
    with trace.stage_timer("a"), trace.stage_timer("b"):
        pass
    trace.enable(ranges=False)
    with trace.stage_timer("c"):
        pass
    assert entered == ["r2f.a", "r2f.b"]


@pytest.mark.parametrize("path", ["fused", "staged"])
def test_recording_on_gives_process_one_request_tree(dng, path):
    trace.enable(ranges=False)
    out = Processor(device="cpu").process(dng, **STOCKS, seed=1, **(FUSED if path == "fused" else {}))
    (tree,) = trace.requests()
    root = tree[0]
    assert root.name == "process" and root.parent is None
    assert all(s.request == root.request and s.end_ns is not None for s in tree)
    names = _names(tree)
    once = ["bundle", "render", "render.download", "finish"]
    once += ["prep", "prep.read", "prep.exposure"] if path == "fused" else ["decode", "geometry"]
    assert all(names.count(n) == 1 for n in once), names
    by_name = {s.name: s for s in tree}
    assert by_name["bundle"].counts == {"bundle.miss": 1}
    assert by_name["prep.exposure" if path == "fused" else "geometry"].parent == by_name[
        "prep" if path == "fused" else "process"].id
    assert {"render.develop", "render.print"} <= set(names)
    assert all(by_name[n].parent == by_name["render"].id for n in ("render.develop", "render.print"))
    assert out.shape == (64, 96, 3) if path == "fused" else out.ndim == 3


def test_copy_helpers_count_only_crossings(monkeypatch):
    a = np.arange(60, dtype=np.uint8).reshape(3, 4, 5)
    trace.to_device(a, "cpu", torch.float32)
    trace.to_host(torch.zeros(3))
    assert not any(k.startswith("copy.") for k in trace.COUNTS)  # on the CPU nothing crosses
    # The CPU taken for a device: a host array or tensor going there crosses,
    # and so does a tensor coming back; a tensor moved between devices does not.
    monkeypatch.setattr(trace, "on_host", lambda t: False)
    trace.enable(ranges=False)
    with trace.stage_timer("up") as up:
        out = trace.to_device(a, "cpu", torch.float32)
        trace.to_device(torch.zeros(2, 3), "cpu", copy=True)
    with trace.stage_timer("down") as down:
        trace.to_host(torch.zeros(7, dtype=torch.int16))
    assert out.dtype == torch.float32 and torch.equal(out, torch.from_numpy(a).float())
    assert up.counts == {"copy.h2d.n": 1, "copy.h2d.bytes": 60 * 4}
    assert down.counts == {"copy.d2h.n": 1, "copy.d2h.bytes": 14}
    assert trace.COUNTS == {"copy.h2d.n": 1, "copy.h2d.bytes": 240, "copy.d2h.n": 1, "copy.d2h.bytes": 14}


def test_to_host_pins_only_large_cuda_copies(monkeypatch):
    """A host tensor comes back as itself, uncounted. The test of a pinned
    landing is the device type, not ``on_host``: a 2 MiB CPU tensor taken
    for a device's is counted as a copy down and still takes ``.cpu()``,
    never ``pin_memory`` (which a CPU-only torch cannot serve)."""
    host = torch.zeros(2 << 20, dtype=torch.uint8)
    assert trace.to_host(host) is host and trace.COUNTS == {}
    monkeypatch.setattr(trace, "on_host", lambda t: False)
    assert trace.to_host(host) is host  # a pinned landing would be a new tensor
    assert trace.COUNTS == {"copy.d2h.n": 1, "copy.d2h.bytes": 2 << 20}


def test_launch_counts_are_the_launch_counters():
    before = dict(kb.launches)
    assert list(before) == list(kb.KERNELS)
    trace.count("launch.demosaic")
    trace.count("launch.demosaic")
    assert kb.launches["demosaic"] == before["demosaic"] + 2 == trace.COUNTS["launch.demosaic"]
    kb.launches["halation"] = 5
    assert trace.COUNTS["launch.halation"] == 5
    kb.reset_launches()
    assert all(v == 0 for v in kb.launches.values()) and trace.COUNTS["launch.demosaic"] == 0
    with pytest.raises(KeyError):
        kb.launches["no_such_kernel"]


# The routes to the density (``render.py::_chain``): K14 develops on the /4
# mixture tier (the 45 MP frame's 228 px/mm) with identity masking; the plain
# ``_develop`` runs with halation off, with colour masking, and on the tiers
# below /4 (halation size 0.5: a 28.5 px glow, the SVD tier).
DEVELOP_ROUTES = {
    "halation off": (dict(halation=False), "develop.plain"),
    "colour masking 0.5": (dict(color_masking=0.5), "develop.plain"),
    "below the /4 tier": (dict(halation_size=0.5), "develop.plain"),
    "/4 tier, identity masking": ({}, "develop.fused"),
}
NORM = (0.0, 1.0 / 60000.0)  # _mosaic's codes to [0, 1]


def _render_small(**params):
    from raw2film_tpu_torch.data import REC709_TO_XYZ
    from raw2film_tpu_torch.pipeline.render import load_film_bundle, render_chain_from_mosaic

    bundle, cfg = load_film_bundle(device="cpu", grain=2, sharpness=True, highlight_burn=0.3, **params)
    codes = _mosaic(64, 384, 4).astype(np.uint16)
    out = render_chain_from_mosaic(codes, REC709_TO_XYZ, bundle, cfg, 7, norm=NORM, device="cpu")
    return cfg, out


@pytest.mark.parametrize("route", list(DEVELOP_ROUTES))
def test_each_frame_counts_its_develop_route(route):
    params, counter = DEVELOP_ROUTES[route]
    trace.enable(ranges=False)
    cfg, _ = _render_small(**params)
    assert cfg.mask_identity == (params.get("color_masking", 1.0) == 1.0)
    other = "develop.fused" if counter == "develop.plain" else "develop.plain"
    assert trace.COUNTS.get(counter) == 1 and other not in trace.COUNTS
    (tree,) = trace.requests()  # counted inside the frame's request tree
    assert sum((s.counts or {}).get(counter, 0) for s in tree) == 1
    assert ("render.develop" in _names(tree)) == (counter == "develop.plain")


def test_the_develop_span_takes_the_exposure_as_its_device(monkeypatch):
    from raw2film_tpu_torch.pipeline import render

    given = []
    timer = render.stage_timer
    monkeypatch.setattr(render, "stage_timer",
                        lambda name, device=None: given.append((name, device)) or timer(name, device))
    _render_small(halation=False)
    (dev,) = [d for name, d in given if name == "render.develop"]
    assert isinstance(dev, torch.Tensor) and tuple(dev.shape) == (3, 64, 384)


@pytest.mark.cuda
def test_the_develop_span_records_an_event_pair_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a span records an event pair only on a CUDA tensor")
    from raw2film_tpu_torch.data import REC709_TO_XYZ
    from raw2film_tpu_torch.pipeline.render import load_film_bundle, render_chain_from_mosaic

    bundle, cfg = load_film_bundle(device="cuda", halation=False, grain=2, sharpness=True, highlight_burn=0.3)
    codes = torch.from_numpy(_mosaic(408, 612, 5).astype(np.uint16))
    render_chain_from_mosaic(codes, REC709_TO_XYZ, bundle, cfg, 7, norm=NORM)  # builds the kernels
    trace.enable(ranges=False)
    render_chain_from_mosaic(codes, REC709_TO_XYZ, bundle, cfg, 8, norm=NORM)
    torch.cuda.synchronize()
    (tree,) = trace.requests()
    (develop,) = [s for s in tree if s.name == "render.develop"]
    assert develop.events is not None and develop.device_ms() > 0
    assert sum((s.counts or {}).get("develop.plain", 0) for s in tree) == 1  # the traced frame's
    assert trace.COUNTS["develop.plain"] == 2 and "develop.fused" not in trace.COUNTS  # both frames


class _Blocking:
    """A Processor stand-in whose first ``process`` waits for ``go``."""

    device = "cpu"
    last_frame_device = None  # finishes nothing on a device

    def __init__(self):
        self.started, self.go, self.calls = threading.Event(), threading.Event(), 0

    def process(self, src, **params):
        self.calls += 1
        if self.calls == 1:
            self.started.set()
            assert self.go.wait(60)
        return np.zeros((4, 6, 3), np.uint8)


def test_preview_counts_the_requests_latest_wins_dropped():
    trace.enable(ranges=False)
    proc, frames = _Blocking(), []
    done = threading.Event()
    engine = PreviewEngine(
        proc, on_frame=lambda img, hist: (frames.append(img), len(frames) == 2 and done.set())
    )
    try:
        engine.request("first")
        assert proc.started.wait(60)
        for k in range(3):  # while the first renders: two of these are dropped
            engine.request(f"next-{k}")
        proc.go.set()
        assert done.wait(60)
    finally:
        engine.close()
    first, second = trace.requests()
    assert [s.name for s in first[:2]] == [s.name for s in second[:2]] == ["preview.frame", "preview.wait"]
    assert first[0].counts is None and second[0].counts == {"preview.coalesced": 2}
    assert trace.COUNTS["preview.coalesced"] == 2


def test_cli_trace_prints_the_summary_and_turns_recording_off(tmp_path, capsys):
    from raw2film_tpu_torch.cli import main

    src = tmp_path / "c.dng"
    write_dng(str(src), _mosaic(64, 96, 2), white_level=60000)
    assert main([str(src), "-o", str(tmp_path / "out"), "--grain", "0", "--device", "cpu", "--trace"]) == 0
    out = capsys.readouterr().out
    for line in ("[trace] batch.render: 1 x ", "[trace] process: 1 x ", "[trace] read: 1 x ",
                 "[trace] bundle.miss: 1"):
        assert line in out, out
    assert not trace.recording()


@pytest.mark.cuda
def test_copy_counters_of_a_fused_process_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on an NVIDIA GPU")
    h, w = 408, 612
    src = str(tmp_path / "f.dng")
    write_dng(src, _mosaic(h, w, 3), white_level=60000)
    proc = Processor(device="cuda")
    proc.process(src, **STOCKS, seed=1, **FUSED)  # builds and loads the kernels; caches the mosaic
    torch.cuda.synchronize()

    def traced_counts(**kw):
        trace.reset_stats()
        trace.enable(ranges=False)
        out = proc.process(src, **STOCKS, **FUSED, **kw)
        torch.cuda.synchronize()
        (tree,) = trace.requests()
        counts = {}
        for s in tree:
            for k, v in (s.counts or {}).items():
                counts[k] = counts.get(k, 0) + v
        assert out.shape == (h, w, 3)
        return counts, tree

    counts, tree = traced_counts(seed=2, cache=False)  # the fused prep runs, as in an export
    assert counts["copy.h2d.bytes"] == h * w * 2  # the uint16 mosaic, once
    # the uint8 frame and K15's float64 sum
    assert counts["copy.d2h.bytes"] == h * w * 3 + 8 and counts["copy.d2h.n"] == 2
    assert counts["launch.exposure_sample"] == 1
    kernels = [s for s in tree if s.name.startswith("kernel.")]
    assert kernels and all(s.device_ms() > 0 for s in kernels)
    # the mosaic cached by the first call stays on the device: nothing goes up
    counts, _ = traced_counts(seed=3)
    assert "copy.h2d.bytes" not in counts and "launch.exposure_sample" not in counts
    assert counts["copy.d2h.bytes"] == h * w * 3


@pytest.mark.cuda
def test_large_copies_down_land_in_pinned_memory():
    """On the card: ``to_host`` equals ``.cpu()`` bit for bit (a contiguous
    45 MP uint8 frame, a float32 XYZ, a strided view of its green plane);
    a copy of 1 MiB or more is page-locked and counted as pinned once, one
    byte less is neither; a same-size copy after the first is released
    reuses the cached block."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: page-locked landings are made only from a CUDA tensor")
    gen = torch.Generator(device="cuda").manual_seed(7)
    frame = torch.randint(0, 256, (3, 5472, 8208), dtype=torch.uint8, device="cuda", generator=gen)
    xyz = torch.rand((3, 2000, 3000), device="cuda", generator=gen)
    for t in (frame, xyz, xyz[1, ::2, ::2]):
        got = trace.to_host(t)
        assert got.is_pinned() and got.is_contiguous() and got.dtype == t.dtype
        assert torch.equal(got, t.cpu())
    nbytes = [t.numel() * t.element_size() for t in (frame, xyz, xyz[1, ::2, ::2])]
    assert trace.COUNTS["copy.d2h.pinned.n"] == trace.COUNTS["copy.d2h.n"] == 3
    assert trace.COUNTS["copy.d2h.pinned.bytes"] == trace.COUNTS["copy.d2h.bytes"] == sum(nbytes)

    trace.reset_stats()
    at = torch.ones(trace.PINNED_MIN_BYTES, dtype=torch.uint8, device="cuda")
    below = at[1:]
    assert trace.to_host(at).is_pinned() and not trace.to_host(below).is_pinned()
    assert trace.COUNTS["copy.d2h.pinned.n"] == 1 and trace.COUNTS["copy.d2h.n"] == 2
    assert trace.COUNTS["copy.d2h.pinned.bytes"] == trace.PINNED_MIN_BYTES

    first = trace.to_host(frame).numpy().transpose(1, 2, 0)  # what a caller keeps
    del first
    before = torch.cuda.host_memory_stats()
    again = trace.to_host(frame)
    after = torch.cuda.host_memory_stats()
    assert again.is_pinned()
    assert after["num_host_alloc"] == before["num_host_alloc"]
    assert after["allocated_bytes.current"] <= before["allocated_bytes.current"]
