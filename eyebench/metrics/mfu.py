"""mfu: the logical FLOPs of the forwards run in the traced window (the
benchmark's frozen ledger, each forward counted at its photos and with or
without the FOV head, as it ran) over the window's seconds and the card's
dense bf16 peak, looked up by its exact name; percent. In the batch cells,
judged by photos per second."""

from eyebench.harness import ledger


def read(run):
    return ledger.window_mfu(run)
