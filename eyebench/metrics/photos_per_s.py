"""photos_per_s: photos completed in the window over the window's seconds,
from its first timed photo to the end of its last."""


def read(run):
    return run.window.photos / run.window_s
