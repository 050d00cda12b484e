"""The mean, in ms, over the window's requests of the program's span
``prep.exposure``: the fused path's host exposure estimate (the host
half-size decode and ``calc_exposure``) inside the host preparation."""

from portbench import program

program.record()


def read(run):
    return program.span_ms(run, lambda name: name == "prep.exposure")
