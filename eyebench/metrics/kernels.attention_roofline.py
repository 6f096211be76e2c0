"""kernels.attention_roofline: the least time the card could take for the
attention of the forwards run in the traced window, worked out from the
model's shapes (the architecture's ``attention_calls``; Depth Pro's: the
patch and image ViTs in the ViT's dtype, the FOV ViT in f32 where it ran),
over the device time of the kernels named below; percent."""

from eyebench.harness import architecture, ledger, trace

# the port's attention: the tensor-core kernels, the CUDA-core one, and the
# f32 path's split pre-pass (``ops/flash_attention.py``, ``csrc/attention_qkv.cu``)
NAMES = ("attention_wgmma", "attention_tf32", "attention_kernel",
         "split_tf32")


def read(run):
    spent = trace.device_s(run.ops, lambda name: any(k in name for k in NAMES))
    peak = ledger.peak(run.kind)
    if spent <= 0 or peak is None:
        return None
    arch = architecture.of(run.config)
    vit = arch.policy_dtypes(run.policy)["vit"]
    calls = []
    for n, variant in run.window.forwards:
        calls += arch.attention_calls(run.config["model"], n, variant, vit)
    return 100.0 * ledger.attention_bound_s(calls, run.kind) / spent
