"""dispatch.replay_share: the share of the program calls in the traced
window that replayed a CUDA graph (``dispatch.replay`` spans over every
``dispatch.*`` span); percent."""

from eyebench.harness import program


def read(run):
    calls = [s for s in program.spans(run) or () if s.name.startswith("dispatch.")]
    if not calls:
        return None
    return 100.0 * sum(s.name == "dispatch.replay" for s in calls) / len(calls)
