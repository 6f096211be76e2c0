"""mfu.photo: ``mfu`` in the one-photo cell, judged by its photos' 90th
percentile wall time: the logical FLOPs of the window's forwards over the
window's seconds and the card's dense bf16 peak; percent."""

from eyebench.harness import ledger


def read(run):
    return ledger.window_mfu(run)
