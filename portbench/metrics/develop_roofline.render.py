"""The plain development's share of its roofline, in %: its least time over
the device time of a CUDA event pair around each call of
``pipeline/render.py::_develop`` (the program's counterpart is its device
span ``render.develop``). None where ``_develop`` did not run: K14 develops
the density wherever halation takes the /4 mixture tier with identity
masking.

The least time is that of the bytes: the (3, H, W) float32 exposure read
once and the density written once, 24 B a pixel (1,077,940,224 B at 5472 x
8208, 0.322 ms at 3.35 TB/s). The float32 operations bound less tightly:
:data:`OPS_PER_VALUE` a pixel and channel, counting each ``log2`` and
``exp2`` as one operation (a lower bound: they run on the special function
units, which issue fewer a cycle than the FMA pipes) and a multiply-add as
two; 31 x 3 x 44,914,176 is 4.18 GFLOP, 0.062 ms at 67 TFLOP/s. Either way
the share is a lower bound on what a kernel could reach: the plain version
writes and reads back every intermediate plane."""

from portbench import roofline

SPANS = {"develop": ("raw2film_tpu_torch.pipeline.render", "_develop", "device")}

# ``Ref.develop`` a pixel and channel: the flare add and the log10's scale
# (2), its log2 (1); each of the two softplus terms a subtract, two scales,
# the 1 + ..., a multiply-add and the width's scale (7) with its exp2 and
# log2 (2); their difference, gamma's multiply-add and the d_min subtract
# (4); the 3x3 mask, a multiply, two multiply-adds and the d_min add (6).
OPS_PER_VALUE = 2 + 1 + 2 * (7 + 2) + 4 + 6


def read(run):
    span = run.spans.get("develop")
    if span is None or not span.device_ms:
        return None
    f = run.config["frame"]
    values = 3 * f["height"] * f["width"]
    nbytes = 2 * values * 4
    flops = OPS_PER_VALUE * values
    measured = sum(span.device_ms) / len(span.device_ms) / 1e3
    return roofline.share_pct(roofline.least_s(nbytes, flops), measured)
