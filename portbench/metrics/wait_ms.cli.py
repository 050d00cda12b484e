"""The host time, in ms, of the program's span ``roll.wait`` per frame of
the window's requests (the counter ``roll.frames``): the renderer waiting
on the decode pool's queue, the part of the read the pool did not hide."""

from portbench import program

program.record()


def read(run):
    frames = program.counted(run, "roll.frames")
    ms = program.span_ms(run, lambda name: name == "roll.wait")
    return None if not frames or ms is None else ms / frames
