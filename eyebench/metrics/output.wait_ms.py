"""output.wait_ms: host milliseconds per photo blocked in the output's wait
for the card's result (the program's ``output.wait`` spans: the render's
copy to the host, and whatever device work is queued before it), in the
traced window."""

from eyebench.harness import program


def read(run):
    return program.ms_per_photo(run, "output.wait")
