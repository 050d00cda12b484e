"""The mean, in ms, over the window's requests of the program's ``bundle``
spans, summed in each: the film bundle rebuilt on the host and uploaded
when a slider changes it (0 on a cache hit)."""

from portbench import program

program.record()


def read(run):
    return program.span_ms(run, lambda name: name == "bundle")
