"""The full-res halation stage's share of its roofline, in %: its least
time (bytes: the (3, H, W) float32 exposure read and the density written,
and the (3, H, ceil(W/4)) row-upsampled pyramid blur read; or operations:
the true taps of the full-res ranks, the x4 column lerp (3) and the combine
(3) a pixel and channel) over the device time of a CUDA event pair around
each call of ``ops/halation.py::halation_mega`` (K14). The development to
density in the same kernel is not counted: a lower bound."""

from portbench import roofline
from portbench import settings as st
from portbench.ref import chain

SPANS = {"halation": ("raw2film_tpu_torch.ops.halation", "halation_mega", "device")}


def read(run):
    span = run.spans.get("halation")
    if span is None or not span.device_ms:
        return None
    f, s = run.config["frame"], run.config["settings"]
    h, w = f["height"], f["width"]
    us, vs, _ = chain.halation_taps(st.scale(run.config) / 4.0 * float(s["halation_size"]))
    flops = roofline.rank_flops(us, vs, h, w) + 6.0 * h * w * 3
    nbytes = (2 * 3 * h * w + 3 * h * (-(-w // 4))) * 4
    measured = sum(span.device_ms) / len(span.device_ms) / 1e3
    return roofline.share_pct(roofline.least_s(nbytes, flops), measured)
