"""The mean, in ms, over the window's requests of every program span named
``*.download``, summed in each: the copies of images to the host, waiting
on the device work they depend on included."""

from portbench import program

program.record()


def read(run):
    return program.span_ms(run, lambda name: name.endswith(".download"))
