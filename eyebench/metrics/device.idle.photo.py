"""device.idle.photo: the share of the traced window in which no kernel
ran on the card (copies between host and card alone count as idle), in the
one-photo cell, judged by its photos' 90th percentile wall time; percent."""

from eyebench.harness import trace


def read(run):
    return trace.idle_percent(run)
