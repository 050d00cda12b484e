"""Output megapixels of every render finished in the window, over the
window (host clock; each request ends in a device synchronise)."""


def read(run):
    mp = run.units.get("mp")
    return mp / run.window_s if mp else None
