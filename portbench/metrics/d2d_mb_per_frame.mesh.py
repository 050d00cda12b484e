"""The program's counter ``copy.d2d.bytes`` per frame of the window's
requests (the counter ``mesh.frames``), in MB (1e6 bytes): what each frame
copied from one card to another."""

from portbench import program

program.record()


def read(run):
    frames = program.counted(run, "mesh.frames")
    n = program.counted(run, "copy.d2d.bytes")
    return None if not frames or n is None else n / frames / 1e6
