"""The host time, in ms, of the program's spans ``*.download`` per frame of
the window's requests (the counter ``mesh.frames``): each frame's uint8
copy from its card to the host, waiting on the render it depends on
included, four frames at once on a batch mesh of four."""

from portbench import program

program.record()


def read(run):
    frames = program.counted(run, "mesh.frames")
    ms = program.span_ms(run, lambda name: name.endswith(".download"))
    return None if not frames or ms is None else ms / frames
