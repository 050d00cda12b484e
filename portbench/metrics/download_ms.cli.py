"""The host time, in ms, of the program's spans named ``*.download`` per
frame of the window's requests (the counter ``roll.frames``): the copies
of rendered frames to the host, waiting on the device work they depend on
included."""

from portbench import program

program.record()


def read(run):
    frames = program.counted(run, "roll.frames")
    ms = program.span_ms(run, lambda name: name.endswith(".download"))
    return None if not frames or ms is None else ms / frames
