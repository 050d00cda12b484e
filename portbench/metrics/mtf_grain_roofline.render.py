"""The MTF + colour grain stage's share of its roofline, in %: its least
time (bytes: the (3, H, W) float32 density read once and written once; or
operations: the true taps of the MTF's per-channel ranks and the grain
field's two 1-D passes, a multiply-add each) over the device time of a CUDA
event pair around each call of ``ops/mtf.py::film_sharpness_grain`` (K2)."""

from portbench import roofline
from portbench import settings as st
from portbench.ref import chain
from portbench.ref.film import loader

SPANS = {"mtf_grain": ("raw2film_tpu_torch.ops.mtf", "film_sharpness_grain", "device")}


def read(run):
    span = run.spans.get("mtf_grain")
    if span is None or not span.device_ms:
        return None
    f, s = run.config["frame"], run.config["settings"]
    h, w = f["height"], f["width"]
    scale = st.scale(run.config)
    neg = loader.load_film_stocks()[s["negative_film"]]
    u3, v3 = chain.mtf_taps(neg.mtf, scale, bool(s.get("mtf_fidelity", False)))
    taps = chain.grain_taps(float(s["grain_size"]) / 1000.0 * scale * float(s["grain_sigma"]))
    flops = roofline.rank_flops(u3, v3, h, w) + 2.0 * 2 * len(taps) * h * w * 3
    nbytes = 2 * 3 * h * w * 4
    measured = sum(span.device_ms) / len(span.device_ms) / 1e3
    return roofline.share_pct(roofline.least_s(nbytes, flops), measured)
