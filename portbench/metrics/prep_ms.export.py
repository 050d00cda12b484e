"""The mean self time, in ms, over the window's calls of a host-clock span
around ``Processor._try_load_mosaic_impl`` less the ``read_raw`` inside it:
the fused path's host preparation (the exposure estimate on the host
half-size decode, the aspect crop)."""

from portbench.spans import self_time_s

SPANS = {
    "prep": ("raw2film_tpu_torch.pipeline.processor", "Processor._try_load_mosaic_impl", "host"),
    "read": ("raw2film_tpu_torch.io.dng", "read_raw", "host"),
}


def read(run):
    prep, rd = run.spans.get("prep"), run.spans.get("read")
    if prep is None or rd is None or not prep.count:
        return None
    own = self_time_s(prep, rd)
    return 1e3 * sum(own) / len(own)
