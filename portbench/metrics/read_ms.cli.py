"""The host time, in ms, of the program's span ``read`` per frame of the
window's requests (the counter ``roll.frames``): the CLI's decode pool
parsing and reading each DNG (``io/dng.py::read_raw``), ``--jobs`` threads
at once, under the roll's root."""

from portbench import program

program.record()


def read(run):
    frames = program.counted(run, "roll.frames")
    ms = program.span_ms(run, lambda name: name == "read")
    return None if not frames or ms is None else ms / frames
