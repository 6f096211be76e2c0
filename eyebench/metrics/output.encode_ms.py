"""output.encode_ms: host milliseconds per photo in the striped PNG encode
and the file's write (the program's ``output.encode`` spans), in the traced
window."""

from eyebench.harness import program


def read(run):
    return program.ms_per_photo(run, "output.encode")
