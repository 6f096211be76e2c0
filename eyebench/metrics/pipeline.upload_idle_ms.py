"""pipeline.upload_idle_ms: milliseconds per photo with no kernel running on
the card while the photo's copy to the card (the program's
``pipeline.upload`` span) is the innermost open program span, in the
traced window."""

from eyebench.harness import program


def read(run):
    return program.idle_ms_per_photo(run, "pipeline.upload")
