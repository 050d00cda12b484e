"""The host time, in ms, of the program's span ``geometry`` per frame of
the window's requests (the counter ``roll.frames``): ``load_image``'s round
trip of the decoded XYZ through the host (download, lens correction, crop,
upload, and the resize to the cap where it bites)."""

from portbench import program

program.record()


def read(run):
    frames = program.counted(run, "roll.frames")
    ms = program.span_ms(run, lambda name: name == "geometry")
    return None if not frames or ms is None else ms / frames
