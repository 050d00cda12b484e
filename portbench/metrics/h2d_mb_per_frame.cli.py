"""The program's counter ``copy.h2d.bytes`` per frame of the window's
requests (the counter ``roll.frames``), in MB (1e6 bytes): what each frame
copied from the host to the card (the mosaic, and the XYZ's way back up
from the geometry's round trip)."""

from portbench import program

program.record()


def read(run):
    frames = program.counted(run, "roll.frames")
    n = program.counted(run, "copy.h2d.bytes")
    return None if not frames or n is None else n / frames / 1e6
