"""output.resize_ms: host milliseconds per photo in the native Lanczos3
upsizing of the depth map's grid image to the photo's size (the program's
``output.resize`` spans), in the traced window."""

from eyebench.harness import program


def read(run):
    return program.ms_per_photo(run, "output.resize")
