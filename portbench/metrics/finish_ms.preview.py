"""The mean, in ms, over the window's calls of a host-clock span around
``Processor._finish``: the canvas, the resize back to the decoded size on
the device, the download, and the clip and cast."""

SPANS = {"finish": ("raw2film_tpu_torch.pipeline.processor", "Processor._finish", "host")}


def read(run):
    span = run.spans.get("finish")
    if span is None or not span.count:
        return None
    return 1e3 * sum(span.host_s()) / span.count
