"""kernels.conv3x3_roofline: the least time the card could take for the
forwards' 3x3 stride-1 convolutions as published (the architecture's
``conv3x3_calls``; Depth Pro's 24: the decoder's projections and residual
units, the head's two), in the decoder's dtype, over the device time of
the kernels named below; percent."""

from eyebench.harness import architecture, ledger, trace

# the port's 3x3 conv (``ops/conv3x3.py``, ``csrc/conv3x3.cu``): every kernel
# of the library, the f32 path's weight pre-pass and split-K reduction included
NAMES = ("conv3x3",)


def read(run):
    spent = trace.device_s(run.ops, lambda name: any(k in name for k in NAMES))
    peak = ledger.peak(run.kind)
    if spent <= 0 or peak is None:
        return None
    arch = architecture.of(run.config)
    dt = arch.policy_dtypes(run.policy)["decoder"]
    calls = []
    for n, _variant in run.window.forwards:
        calls += arch.conv3x3_calls(run.config["model"], n, dt)
    return 100.0 * ledger.conv3x3_bound_s(calls, run.kind) / spent
