"""primitives.other_ms: device milliseconds per photo in kernels that are
neither the port's own nor cuBLAS's or cuDNN's: PyTorch's elementwise
passes, reductions and copy kernels (``ops/nn.py``, ``ops/mixed.py``,
``ops/quant.py``), in the traced window. Copies between host and card
(memcpy, memset) are not kernels and are left out."""

from eyebench.harness import trace

# the port's own kernels (``csrc/*.cu``)
PORT = ("attention_wgmma", "attention_tf32", "attention_kernel",
        "split_tf32", "conv3x3", "linker_scan", "threefry")
# the libraries: cuBLAS's GEMMs (nvjet_* are its Hopper kernels) and cuDNN
LIBRARY = ("gemm", "xmma", "cutlass", "cublas", "nvjet", "cudnn", "conv")


def other(name: str) -> bool:
    low = name.lower()
    return not (any(k in name for k in PORT) or any(k in low for k in LIBRARY)
                or trace.is_transfer(name))


def read(run):
    spent = trace.device_s(run.ops, other)
    if spent <= 0 or not run.window.photos:
        return None
    return 1e3 * spent / run.window.photos
