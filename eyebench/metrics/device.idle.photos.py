"""device.idle.photos: the share of the traced window in which no kernel
ran on the card (copies between host and card alone count as idle), in a
batch cell, judged by photos per second; percent."""

from eyebench.harness import trace


def read(run):
    return trace.idle_percent(run)
