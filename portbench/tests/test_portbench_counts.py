"""The roofline arithmetic against hand counts at small shapes, and the
readers of the spans and the trace against made-up readings."""

import numpy as np
import pytest

from portbench import bench, roofline
from portbench import settings as st
from portbench.ref import chain
from portbench.spans import Span, TraceSummary, self_time_s


def test_true_taps_and_rank_flops_by_hand():
    u = np.array([[0, 1, 2, 1, 0], [0, 0, 3, 0, 0], [0, 0, 0, 0, 0]], np.float32)
    v = np.array([[1, 1, 1, 1, 1], [0, 2, 2, 2, 0], [1, 0, 0, 0, 0]], np.float32)
    assert list(roofline.true_taps(u)) == [3, 1, 0]
    assert list(roofline.true_taps(v)) == [5, 3, 5]
    # rank 0: 3 + 5 taps, rank 1: 1 + 3, rank 2 has no column taps: 12 multiply-adds
    assert roofline.rank_flops(u, v, 4, 6, c=3) == 2 * 12 * 4 * 6 * 3
    per_channel = np.stack([u, u * 0])  # the second channel's ranks are all zero
    assert list(roofline.true_taps(per_channel)) == [3, 1, 0]


def test_least_time_takes_the_larger_bound():
    assert roofline.least_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert roofline.least_s(0.0, 67e12) == pytest.approx(1.0)
    assert roofline.least_s(3.35e9, 67e12) == pytest.approx(1.0)
    assert roofline.share_pct(0.5, 2.0) == pytest.approx(25.0)


def _run(config, name, ms):
    run = bench.Run({"chips": 1}, config, {}, "cuda")
    span = Span(name, "device")
    span.device_ms = list(ms)
    run.spans[name] = span
    return run


def _config(h, w):
    conf = bench.resolve(bench.load_spec(), "render-45mp")["config"]
    scale = st.scale(conf)
    conf["frame"]["height"], conf["frame"]["width"] = h, w
    conf["settings"]["frame_height"], conf["settings"]["frame_width"] = h / scale, w / scale
    return conf


def test_mtf_grain_roofline_by_hand():
    conf = _config(8, 12)
    s = conf["settings"]
    from portbench.ref.film import loader

    scale = st.scale(conf)
    u3, v3 = chain.mtf_taps(loader.load_film_stocks()[s["negative_film"]].mtf, scale)
    taps = chain.grain_taps(s["grain_size"] / 1000 * scale * s["grain_sigma"])
    mac = sum(int((np.abs(np.arange(k.shape[-1]) - k.shape[-1] // 2)[np.any(k[:, r] != 0, 0)]).max()) * 2 + 1
              for k in (u3, v3) for r in range(u3.shape[1]))
    flops = 2 * mac * 8 * 12 * 3 + 2 * 2 * len(taps) * 8 * 12 * 3
    least = max(2 * 3 * 8 * 12 * 4 / 3.35e12, flops / 67e12)
    reader = bench.load_metric("mtf_grain_roofline.render")
    assert reader.read(_run(conf, "mtf_grain", [least * 4e3, least * 4e3])) == pytest.approx(25.0)
    assert reader.read(_run(conf, "mtf_grain", [])) is None


def test_halation_roofline_by_hand():
    conf = _config(8, 12)
    us, vs, _ = chain.halation_taps(st.scale(conf) / 4.0)
    mac = sum(int(roofline.true_taps(t)[r]) for t in (us, vs) for r in range(us.shape[0]))
    flops = 2 * mac * 8 * 12 * 3 + 6 * 8 * 12 * 3
    nbytes = (2 * 3 * 8 * 12 + 3 * 8 * 3) * 4
    least = max(nbytes / 3.35e12, flops / 67e12)
    reader = bench.load_metric("halation_roofline.render")
    assert reader.read(_run(conf, "halation", [least * 2e3])) == pytest.approx(50.0)


def test_self_time_takes_the_children_out():
    parent, child = Span("prep", "host"), Span("read", "host")
    parent.intervals = [(0.0, 1.0), (2.0, 2.5)]
    child.intervals = [(0.1, 0.3), (2.1, 2.2)]
    assert self_time_s(parent, child) == pytest.approx([0.8, 0.4])


def test_trace_summary_busy_and_idle_gaps():
    device = [("k1", 0.0, 10.0), ("k2", 5.0, 10.0), ("k1", 40.0, 10.0), ("memcpy", 80.0, 20.0)]
    host = [("request", 0.0, 100.0), ("finish", 50.0, 79.0)]
    t = TraceSummary(device, host, 200.0)
    assert t.busy_s == pytest.approx(45e-6) and t.window_s == pytest.approx(200e-6)
    assert t.by_op["k1"] == pytest.approx(20e-6)
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps == {"request": pytest.approx(25e-6), "finish": pytest.approx(30e-6)}
    reader = bench.load_metric("device_idle_share.render")
    run = bench.Run({"chips": 1}, {}, {}, "cuda")
    run.trace = t
    assert reader.read(run) == pytest.approx(100 * (1 - 45 / 200))
