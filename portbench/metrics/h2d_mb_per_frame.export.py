"""The mean, in MB (1e6 bytes), over the window's requests of the program's
counter ``copy.h2d.bytes``: what each request copied from the host to the
device."""

from portbench import program

program.record()


def read(run):
    n = program.counted(run, "copy.h2d.bytes")
    return None if n is None else n / 1e6
