"""The window over the frames ``Processor.process`` returned in it, in ms
(host clock; each request returns the uint8 image on the host)."""


def read(run):
    n = run.units.get("frames")
    return 1e3 * run.window_s / n if n else None
