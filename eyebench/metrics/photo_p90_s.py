"""photo_p90_s: the 90th percentile of every photo's wall time in the window."""

from eyebench.harness.stats import percentile


def read(run):
    return percentile(run.window.latencies, 90)
