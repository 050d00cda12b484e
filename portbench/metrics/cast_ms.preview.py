"""The mean, in ms, over the window's requests of the program's span
``finish.cast``: the host clip and cast to uint8 of the resized float
image in ``Processor._finish``."""

from portbench import program

program.record()


def read(run):
    return program.span_ms(run, lambda name: name == "finish.cast")
