"""kernels.conv3x3_roofline: the least time the card could take for the
forwards' 24 3x3 stride-1 convolutions as published (``ledger.conv3x3_calls``:
the decoder's projections and residual units, the head's two), in the
decoder's dtype, over the device time of the kernels named below; percent."""

from eyebench.harness import ledger, trace

# the port's 3x3 conv (``ops/conv3x3.py``, ``csrc/conv3x3.cu``): every kernel
# of the library, the f32 path's weight pre-pass and split-K reduction included
NAMES = ("conv3x3",)


def read(run):
    spent = trace.device_s(run.ops, lambda name: any(k in name for k in NAMES))
    peak = ledger.peak(run.kind)
    if spent <= 0 or peak is None:
        return None
    dt = ledger.policy_dtypes(run.policy)["decoder"]
    calls = []
    for n, _fov in run.window.forwards:
        calls += ledger.conv3x3_calls(run.config["model"], n, dt)
    return 100.0 * ledger.conv3x3_bound_s(calls, run.kind) / spent
