"""The host time, in ms, of the program's span ``decode`` per frame of the
window's requests (the counter ``roll.frames``): the staged decode
(``io/raw.py::raw_to_linear``): the mosaic's upload, the half-size decode
(K11), the camera matrix, the green plane's fetch and the host power
mean."""

from portbench import program

program.record()


def read(run):
    frames = program.counted(run, "roll.frames")
    ms = program.span_ms(run, lambda name: name == "decode")
    return None if not frames or ms is None else ms / frames
