"""The program's counter ``copy.d2h.bytes`` per frame of the window's
requests (the counter ``roll.frames``), in MB (1e6 bytes): what each frame
copied from the card to the host (the exposure's green plane, the XYZ's
way down for the geometry, the uint8 frame)."""

from portbench import program

program.record()


def read(run):
    frames = program.counted(run, "roll.frames")
    n = program.counted(run, "copy.d2h.bytes")
    return None if not frames or n is None else n / frames / 1e6
