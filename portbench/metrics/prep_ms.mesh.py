"""The host time, in ms, of the program's span ``prep`` less the
``prep.read`` inside it, per frame of the window's requests (the counter
``mesh.frames``): the fused prep's integral check, mosaic upload, exposure
estimate (K15) and aspect crop, on each frame's own card."""

from portbench import program

program.record()


def read(run):
    frames = program.counted(run, "mesh.frames")
    prep = program.span_ms(run, lambda name: name == "prep")
    rd = program.span_ms(run, lambda name: name == "prep.read")
    if not frames or prep is None or rd is None:
        return None
    return (prep - rd) / frames
