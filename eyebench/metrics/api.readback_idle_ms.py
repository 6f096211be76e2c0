"""api.readback_idle_ms: milliseconds per photo with no kernel running on
the card while the batch's copy of its result to the host (the program's
``api.readback`` span) is the innermost open program span, in the traced
window."""

from eyebench.harness import program


def read(run):
    return program.idle_ms_per_photo(run, "api.readback")
