"""The mean, in MB (1e6 bytes), over the window's requests of the program's
counter ``copy.d2h.bytes``: what each request copied from the device to the
host."""

from portbench import program

program.record()


def read(run):
    n = program.counted(run, "copy.d2h.bytes")
    return None if n is None else n / 1e6
