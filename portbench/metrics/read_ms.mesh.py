"""The host time, in ms, of the program's span ``prep.read`` per frame of
the window's requests (the counter ``mesh.frames``): the DNG's parse and
pixel read, four frames at once on a batch mesh of four."""

from portbench import program

program.record()


def read(run):
    frames = program.counted(run, "mesh.frames")
    ms = program.span_ms(run, lambda name: name == "prep.read")
    return None if not frames or ms is None else ms / frames
