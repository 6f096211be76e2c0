"""dispatch.issue_ms: mean host milliseconds of a forward's CUDA-graph
replay (the program's ``dispatch.replay`` spans whose program is a forward,
``fwd_*``: the input copies enqueued, the graph launched, the output clones
enqueued), in the traced window."""

from eyebench.harness import program


def read(run):
    found = [s for s in program.named(run, "dispatch.replay") or ()
             if (s.attrs or {}).get("program", "").startswith("fwd_")]
    if not found:
        return None
    return sum(s.end_ns - s.start_ns for s in found) / 1e6 / len(found)
