"""setup_s: seconds from the set-up clock's start (after the photo pool is
made) to the first timed photo or request: the program's imports, the
card's context, the weights made from the seed, the kernel libraries
loaded or built, and the cell's programs warmed."""


def read(run):
    return run.setup_s
