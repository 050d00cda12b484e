"""The host time, in ms, of the program's span ``prep.exposure`` per frame
of the window's requests (the counter ``mesh.frames``): the fused prep's
exposure estimate (K15 on the frame's own card and its 8-byte fetch)."""

from portbench import program

program.record()


def read(run):
    frames = program.counted(run, "mesh.frames")
    ms = program.span_ms(run, lambda name: name == "prep.exposure")
    return None if not frames or ms is None else ms / frames
