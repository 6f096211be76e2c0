"""matrix_eyes_tpu_torch: the PyTorch/CUDA port of matrix_eyes_tpu.

Photo -> Apple Depth Pro inverse depth -> viridis depth-map PNG, on one
NVIDIA Hopper GPU. Plain tensor code is PyTorch; the JAX package's Pallas
kernels on this path are CUDA C++ kernels written for sm_90a
(``csrc/``), built with nvcc on first use and bound through ctypes. On the
CPU each kernel's wrapper runs its plain PyTorch version. The package
imports torch and never jax; ``matrix_eyes_tpu`` stays the reference.

Layer map:
  CLI            -> cli.py
  orchestration  -> pipeline.py (decode, preprocess, model, output)
  model          -> models/ (vit, encoder, decoder, head, fov, depth_pro)
  primitives     -> ops/ (nn, resize, colormap, attention)
  kernels        -> ops/flash_attention.py + csrc/attention_qkv.cu,
                    ops/conv3x3.py + csrc/conv3x3.cu
  output         -> output/ (depth-map render, PNG)
  weights        -> pt/convert.py, models/init.py
"""

__version__ = "0.1.0"
