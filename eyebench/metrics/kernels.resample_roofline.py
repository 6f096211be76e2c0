"""kernels.resample_roofline: the least time the card could take for the
resamplings of the forwards run in the traced window (the architecture's
``resample_calls``; Depth Anything V2's: each frame's bicubic resize to the
model's input, the fusion blocks' and the head's bilinear upsamplings),
each input read once and each output
written once at 3.35 TB/s, over the device time of the kernels named
below; percent. None where the architecture has no ``resample_calls``."""

from eyebench.harness import architecture, ledger, trace

# PyTorch's upsampling kernels, and any kernel of the port named for it
NAMES = ("upsample_bilinear2d", "upsample_bicubic2d", "resample")
SIZE = {"u8": 1, "bf16": 2, "f16": 2, "f32": 4}


def read(run):
    arch = architecture.of(run.config)
    calls_of = getattr(arch, "resample_calls", None)
    peak = ledger.peak(run.kind)
    if calls_of is None or peak is None:
        return None
    spent = trace.device_s(run.ops, lambda name: any(k in name for k in NAMES))
    if spent <= 0:
        return None
    dtypes = arch.policy_dtypes(run.policy)
    nbytes = 0.0
    for n, variant in run.window.forwards:
        for n_in, dt_in, n_out, dt_out in calls_of(run.config["model"], n, variant, dtypes):
            nbytes += n_in * SIZE[dt_in] + n_out * SIZE[dt_out]
    return 100.0 * nbytes / peak["bytes_per_s"] / spent
