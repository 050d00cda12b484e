"""The share of the traced window, in %, in which no operation ran on the
device: 1 - (the union of the device's busy intervals) / (the window), from
``torch.profiler``."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
