"""The mean, in ms, of the host time of the program's request span
``render`` over the window's frames: the host issuing one frame's device
work, with no synchronise inside it (the request's synchronise follows)."""

from portbench import program

program.record()


def read(run):
    return program.root_ms(run, "render")
