"""matrix_eyes_tpu_torch: the PyTorch/CUDA port of matrix_eyes_tpu.

Photo -> Apple Depth Pro inverse depth -> viridis depth-map PNG, an
autostereogram or an OBJ/PLY mesh, for one photo or a directory of them
(a batch of photos per forward), from the CLI or the ``MatrixEyes`` library
session, on one NVIDIA Hopper GPU. Plain tensor code is PyTorch; the JAX
package's Pallas kernels are CUDA C++ kernels written for sm_90a
(``csrc/``), built with nvcc on first use and bound through ctypes. On the
CPU each kernel's wrapper runs its plain PyTorch version; the entry points
run on the card unless the caller asks for the CPU (``device="cpu"``).
The package imports torch and nothing of the JAX package (it keeps its own
copies of the host modules it needs); ``matrix_eyes_tpu`` stays the
reference.

Layer map:
  CLI            -> cli.py
  library        -> api.py (MatrixEyes)
  orchestration  -> pipeline.py (decode, preprocess, model, output; one
                    photo, or a batch per forward with the output one
                    chunk behind)
  model          -> models/ (vit, encoder, decoder, head, fov, depth_pro)
  primitives     -> ops/ (nn, resize, colormap, attention)
  kernels        -> ops/flash_attention.py + csrc/attention_qkv.cu,
                    ops/conv3x3.py + csrc/conv3x3.cu,
                    ops/stereogram_kernel.py + csrc/linker_scan.cu,
                    ops/prng.py + csrc/threefry.cu (the stereogram's
                    noise: the JAX package's threefry bits)
                    (csrc/hopper.cuh: TMA, mbarrier and wgmma helpers)
  output         -> output/depthmap.py (depth-map, stereogram and mesh
                    render, host copies), output/png.py, output/mesh.py
                    (triangulation), output/writers.py (OBJ, PLY, MTL),
                    output/rust_format.py, native/ (host Lanczos3, striped
                    PNG encoder, OBJ serializer)
  host IO        -> io/image.py, errors.py, progress.py, timings.py
  weights        -> pt/convert.py, models/init.py
"""

__version__ = "0.1.0"
