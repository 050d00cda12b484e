"""From the harness's first line to the first timed request: importing
torch and the program, the CUDA context, the kernel library (built by the
first run in a checkout), the inputs made from the seed, and the warm-up."""


def read(run):
    return run.setup_s
