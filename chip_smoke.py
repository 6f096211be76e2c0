#!/usr/bin/env python3
"""Drive the PyTorch port (matrix_eyes_tpu_torch) on one NVIDIA H100 and check it.

Run from the root of a checkout, on a machine with the card:

    python3 chip_smoke.py

Phases, each a plain call whose failure ends the run with a non-zero exit:

1. environment: versions, the card, its power limit, host encoders;
2. build the six CUDA libraries from matrix_eyes_tpu_torch/csrc/ (one
   nvcc each, all at once), and print ptxas's registers, spills and the
   dynamic shared memory of the tensor-core kernels, the ViT elementwise
   and resample kernels' registers, and the threefry kernel's ptxas report
   and SASS instruction count (``cuobjdump``);
3. each kernel entry against its plain PyTorch version on the card, at the
   shapes the main path gives it, with errors and warm times, the least
   time the card could take (``bound_ms``: the larger of the bytes over
   3.35 TB/s and the FLOPs over 989 TFLOP/s bf16; f32 kernels three TF32
   products at 495 TFLOP/s, with one f32 product on the CUDA cores at 67
   TFLOP/s beside it as ``bound_cuda_core_ms``) and, where one PyTorch call
   computes the same function, that call's time (``library_ms``:
   ``F.conv2d`` on the channels-last view with bias, SDPA on contiguous
   (B, H, N, D); timing yardsticks the port never calls): attention_qkv,
   attention_flash (the separate-q/k/v entry into the same kernel; K and V
   kept whole and streamed), conv3x3 at every distinct conv shape of the
   DEPTH_PRO forward in bf16 and in f32, linker_scan (bit-exact), and the
   threefry noise kernel (``ops/prng.py``: ``jax.random.randint`` of the
   JAX package's stereogram, bit-exact against its plain version at the
   compact, resolved and full-width 12 MP noise planes and a ragged 7x13x3
   one, seeds 0, -1 and 2**31 + 3; its time by CUDA events and by the
   profiler, its bound by integer operations, and the host draw plus
   upload that it replaced); and
   the shapes of a batch of four photos (attention at B = 140 bf16 and the
   FOV's B = 4 f32, conv3x3 at N = 4; under --dtype f32 attention at B =
   140 and the N = 4 hot conv), with one conv past 2^31 elements; and the
   f16 builds (``--dtype f16``): attention_qkv at the patch and image ViT
   shapes, masked, and at TINY's head size 8, attention_flash at the patch
   ViT's shape, conv3x3 at every conv shape of the forward (the bound at
   the f16 dense peak, 989 TFLOP/s; SDPA and ``F.conv2d`` in f16);
4. the main path, ``pipeline.extract_depth``, on a synthetic 3024x4032
   photo at full DEPTH_PRO width (seeded random weights, bf16): the port's
   logical FLOP ledger of one photo (``matrix_eyes_tpu_torch.flops``)
   stage by stage with and without the FOV head and the card's dense bf16
   peak by its exact name, launch counts, conv3x3's launches by shape
   (which weight phase 3's times into per-forward sums), finite inverse
   depth, a 4032x3024 PNG;
5. the same path under ``--dtype f32`` (f32 weights from the same seed,
   ``RuntimeConfig(dtype=torch.float32)``) on the phase-4 photo: the same
   checks, every conv3x3 launch f32, and the f32 per-forward sums;
6. the port on the card against the port on the CPU (plain versions) at
   MID, f32;
7. the stereogram path on the phase-4 photo and weights, each run twice:
   the compact PNG (amplitude 1/16, no linker_scan launch), the
   device-resolved PNG (amplitude 0.1, shifts over 255: one launch) and a
   JPEG (one launch), each drawing its noise with one threefry launch;
   both PNGs decode to 4032x3024 and equal the device-resolved render of
   the same DepthMap and seed;
8. the mesh path on the phase-4 photo (written to disk as a PNG, which the
   vertex colours and the texture refer to) and weights, each run twice: a
   plain PLY, an OBJ with vertex colours and an OBJ with texture
   coordinates and its .mtl; 72/24/0 launches, the headers' vertex and face
   counts equal ``build_mesh`` of the same DepthMap, and the native OBJ
   equals the Python writer's bytes;
9. the batched path: five photos in a directory (the phase-4 photo and four
   seeded variants, one a JPEG with an EXIF focal length, so the mixed
   forward runs) through ``cli.main(["--batch-size=4", in, out])``: two
   chunks (the first mixes known and estimated focal lengths, the second
   is padded from 1 to 4), 144/48 launches, every PNG at its source size;
   each photo's ``MatrixEyes.inverse_depth_batch`` at its chunk's shape
   within the bf16 gate of the one-photo forward of ``MatrixEyes.depth_map``;
   the PNGs within a mean of one count of the --batch-size=1 run's; then photos per second for the
   directory at --batch-size=4 against 1, warm, in turns. The CLI's
   checkpoint reader is answered with the phase-4 weights: the repository
   holds no trained checkpoint;
10-12. the dtype policies ``--dtype=f16``, ``mixed`` and ``int8`` through
   ``cli.main([f"--dtype={policy}", photo, out])`` on the phase-4 photo (as
   a PNG) at full DEPTH_PRO width, each run twice: the checkpoint reader
   (``pt.convert.read_checkpoint``) returns the phase-4 seed's canonical
   f32 tree, so the loader's policy conversion (f16 rounding, int8
   quantization on the card, the mixed layout) runs as it would from a
   .pt. Launches: attention 72 (48 in the ViT's dtype, 24 f32 in the FOV),
   conv3x3 24 in f16, f32 and bf16 respectively, linker_scan 0; the weight
   bytes and the peak device memory; the inverse depth's gap to phase 5's
   f32 run on the same photo and weights, mixed's below bf16's (phase 4);
13. each policy at MID on the card (kernels, the int8 products by cuBLAS)
   against the CPU (plain versions) from the same canonical weights: the
   leaves placed on the card equal those placed on the CPU bit for bit
   (int8 codes and scales included), canonical inverse depth and FOV
   within 5e-3 of max |ref| (f16) and 2e-2 (mixed, int8);
14. the HTTP server (``serve.create_server`` over ``MatrixEyes`` with the
   phase-4 weights, the phase-4 photo as a JPEG body): /healthz; at
   --max-batch=1 the depth-map PNG, the compact stereogram (no linker_scan
   launch) and the PLY equal ``MatrixEyes.process`` of the same file byte
   for byte, /v1/depth ``MatrixEyes.inverse_depth`` bit for bit; at
   --max-batch=4, 8 concurrent /v1/depth requests over four photos, with a
   focal length each within the bf16 gate of its one-photo forward, with
   the FOV head each nearest its own photo's answer (clamp flips, phase
   9), with at least one forward at batch 4 (attention launches at B=140);
   then
   ``scripts/torch_serve_burst.py``: 16 requests at concurrency 8,
   --max-batch=4 against 1, requests/s, p50/p95 latency and one idle
   request's latency, with the outputs on the default stream (the
   server's) and again on a stream of their own;
15. the weight caches: ``cli.main(["--convert-checkpoints", ...])`` cold
   under bf16 at full width (a stand-in .pt gives the stamp, the reader
   returns phase 4's canonical f32 tree) writes the port's caches under
   build/, a warm run with the reader made to raise loads from them alone,
   and its leaves on the card equal the CPU's placement of the tree's f16
   convention bit for bit; cold and warm walls and the cache bytes; then
   int8 and mixed the same way (full width when the disk has 16 GiB free,
   else MID); the caches are deleted; a ``debug.compare_dumps`` table of
   the card against the CPU at MID, f32;
16. multi-device (``parallel/``, ``--devices``) on the one card:
   ``cli.main(["--devices=2", ...])`` exits 1 with the Device error; an
   NCCL world of one rank (``parallel.launch``) gives phase 4's inverse
   depth bit for bit from the phase-4 weights (written to build/ and
   mapped by every rank, each moving only its cut to the card); gloo
   ranks sharing the card run DEPTH_PRO bf16 at 1x2, 2x1 and 2x2: each
   rank's launches (72 attention_qkv at its per-shard shapes, 24 conv3x3),
   its collectives (144 f32 all-reduces under model 2, the patch merge's
   all-gathers under data 2, none with a token axis), the inverse depth
   within the bf16 gate of phase 4's and equal on every rank, and the
   forward's wall, ranks time-sharing one card (no speed-up is measured
   here); MID 2x2 on the card against the same mesh on the CPU under f32
   (phase 6's tolerance) and int8 and mixed (phase 13's: the canonical
   inverse depth and the FOV each within 2e-2); no rank loads jax. Phase 3 holds attention_qkv at the
   per-shard shapes (``PER_SHARD_ATTENTION``);
17. the CUDA-graph cache (``aot.call_cached``) on phase 4's weights and
   photo: preprocess, fwd_fov, fwd_fnorm, fwd_mixed_b4 and the two renders
   under bf16, and fwd_fov under f32, mixed and int8, each called eagerly
   (``MATRIX_EYES_AOT=off``) and then three times through the cache
   (warm-up, capture, replay): the replay bit-equal to the eager call (or
   within its policy's gate, the difference printed), 72 attention and 24
   conv3x3 launches per replayed forward; the resolved stereogram PNG
   written eagerly and three times through the cache, byte for byte the
   same, one linker_scan and one threefry launch each; then seed 8 through
   the same graph (a replay, no new graph), byte for byte the eager seed-8
   call and unlike seed 7, and the same for the compact PNG's
   ``stereogram_noise`` graph; graphs against eager in turns: the
   forward's wall (CUDA events), host time and device time (torch.profiler)
   per call under bf16, mixed, int8 and f32 at one photo and bf16 at four,
   with each forward's model TFLOP and MFU (``flops.mfu`` against the
   card's dense bf16 peak, not reported for a card ``flops._PEAKS`` does
   not name) over the graphs' device time and over their walls;
   the captures' cost and the graph pool's bytes; a clone's cost;
   ``cli.main(["--profile=DIR", ...])`` over three photos whose forwards
   replay, its trace holding their kernels; and the server burst with
   graphs against eager (``scripts/torch_serve_burst.py --compare-aot``,
   two rounds in turns);
18. the mesh's forwards through its CUDA-graph cache (``aot.mesh_cache``):
   (a) an NCCL world of one rank captures ``dist.all_reduce`` and
   ``dist.all_gather_into_tensor`` called directly inside a program of a
   ``GraphCache``, each replay equal to the eager result of its own input;
   (b) the NCCL 1x1 mesh's forward with phase 4's weights
   (``parallel.checks.run_graph_cases``) runs eager, eager, capture,
   replay, 72/24 launches each, the replay bit-equal to its eager call and
   to phase 4's inverse depth, with graphs against eager in turns (wall,
   host issue, device time); then ``fwd_fnorm`` and ``fwd_fnorm_b2`` the
   same way (48/24 launches), each capturing after the previous case's
   graphs were freed with its weights; (c) phase 16's gloo ranks ran every forward
   of the entry points eagerly; (d) with two cards NCCL 1x2 and 2x1, with
   four also 2x2, each replay bit-equal to its eager call and within the
   bf16 gate of phase 4; on one card a line says these meshes run in
   ``scripts/torch_mesh_check.py --graphs``;
19. the ViT block's one-pass elementwise kernels (``csrc/vit_elementwise.cu``:
   ``ops/nn.py``'s ``gelu_`` and ``scaled_residual``) against their plain
   versions, PyTorch's three-pass chains, bit for bit at the main path's
   shapes (``VIT_ELEMENTWISE_SHAPES``) and at ragged ones (GELU in place,
   as the ViT block runs it), with the
   kernel's time by CUDA events and by the profiler, its byte bound at
   3.35 TB/s and the chain's time; then one ``fwd_mixed_b4`` forward of
   DEPTH_PRO under the mixed policy three times through the graph cache
   (eager, capture, replay), each counted: 72 gelu and 144 scaled_residual
   launches, by shape, with ``F.gelu`` made to raise inside the forward;
20. Depth Anything V2 Large (``config.DAV2_LARGE``, seeded random weights,
   bf16): the K/V path the attention library reports at each case of
   ``KV_PATH_CASES``, then ``MatrixEyes.inverse_depth_batch`` over eight
   synthetic 1920x1080 frames three times (eager, capture, replay), each
   counted from 0: 24 attention launches at (8, 2443, 16, 64) on the
   streamed K/V ring, the DPT head's 20 conv3x3 launches by shape
   (``DAV2_CONVS``; phase 3 holds each shape against its plain version), 24
   gelu and 48 scaled_residual launches, the 5 resize_bilinear launches by
   shape (``DAV2_RESAMPLES``), 8 uploads through pinned memory, a finite
   (8, 518, 924) result, the replay equal to the eager call bit for bit;
21. Depth Anything V2's bilinear resampling (``csrc/resample.cu``,
   ``ops/nn.py::resize_bilinear``) against ``F.interpolate`` (its plain
   version, ``resize_bilinear_plain``), bit for bit, at ``RESAMPLE_SHAPES``:
   the five resamplings of a forward over eight 1080p frames, the f32 and
   f16 builds, channel counts below 16 and not a multiple of 8, a
   misaligned input, downsampling, one-pixel inputs and outputs, a copy;
   at the timed shapes the kernel's time by CUDA events and by the
   profiler, its byte bound at 3.35 TB/s (the input read once, the output
   written once) and ``F.interpolate``'s time;
22. the photo's upload (``pipeline.upload``) at a 12 MP photo's and a
   1080p frame's shape (``UPLOAD_SHAPES``): the pinned path bit-equal to
   ``torch.tensor(rgb, device=...)`` for a contiguous, a read-only and a
   strided array, counted once as ("upload", "pinned"); warm, the host's
   staging copy into pinned memory (``pipeline.stage``, the native
   work-sharing copy; PyTorch's OpenMP copy and numpy's assignment beside
   it), the pinned copy to the card by CUDA events and by the host clock,
   the whole upload, and the pageable ``torch.tensor(rgb, device=...)`` it
   replaced, each in GB/s.

Phases 4-16 and 18 run with the graph cache on, its default: a program's first
call with a signature runs eagerly, the second runs eagerly once more and
captures, later ones replay. So where a phase runs a path twice, its first
wall is the eager call and its second includes the capture; a path whose
weights are loaded anew on each run (the CLI's policy and warm-start runs)
runs eagerly each time.

Every path's counts are read from its own first run, each counter set to 0
just before it. In the summary, ``launches_by_path`` gives each kernel's
count on each path (depth-map PNG, the same in f32,
compact PNG, resolved PNG, JPEG, OBJ with vertex colours, the batch-4
directory, the depth-map PNG under --dtype f16, mixed and int8, the served
depth-map PNG, the eight batched /v1/depth requests, the warm start,
rank 0's forward on the meshes NCCL 1x1, 1x2, 2x1 and 2x2 and the entry
points at 2x2, phase 17's replayed forward and replayed stereogram, and
phase 18's replayed forward of rank 0 on each NCCL mesh),
and ``launches`` the count on the path that runs
the kernel: the depth-map PNG for attention_qkv and conv3x3, the resolved
PNG for linker_scan and threefry. No path runs attention_flash (the ViT calls the fused entry):
its ``launches`` is the depth-map run's count, 0.

The last lines are the kernels' summary (JSON), the card's name and power
limit as nvidia-smi prints them, and ``{"ok": true, "device": ...}``. The
run fails without CUDA, outside a checkout of the repository, and if the
port loaded jax or any module of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")  # git-ignored

# f32: the kernels sum in another order than cuBLAS/cuDNN (an online
# softmax; K = 9 * Cin products), so agreement is to rounding, not bits.
F32_RTOL, F32_ATOL = 1e-4, 1e-5
# bf16: both sides round to bf16 at different points (the plain versions
# round the conv before the residual adds and the probabilities before
# P V), so the bound is relative to the output's scale.
BF16_REL = 2e-2
# f16: the same, with three more mantissa bits than bf16
F16_REL = 5e-3
# a policy's forward at MID, card against CPU (canonical inverse depth and
# FOV, relative to the CPU's max): f16 as its kernels; mixed and int8 carry
# bf16 ViT activations, and an int8 activation code flips by one wherever
# two f32 sums round apart
POLICY_MID_REL = {"f16": F16_REL, "mixed": BF16_REL, "int8": BF16_REL}
# a directory's depth-map PNGs at --batch-size=4 against 1: the mean
# difference in u8 counts per channel (bf16 rounding moves the viridis
# index of a pixel by a step or two)
PNG_MEAN_COUNTS = 1.0
# end to end at MID f32 (plain versions on the CPU vs kernels on the card):
# the same per-op rounding differences, carried through every stage.
E2E_RTOL, E2E_ATOL = 1e-3, 1e-4
# linker_scan copies pixels: bit-exact against its plain version.
# threefry hashes integers: bit-exact against its plain version.

STEREO_SEED = 7

# the H100 SXM's dense peaks (NVIDIA data sheet, 700 W): bound_ms is the
# larger of the bytes a call must move and the FLOPs it must do over these;
# bf16 and f16 (989 TFLOP/s) are the port's FLOP ledger's peak for the card
# (``flops._PEAKS``), the number MFU is measured against
H100_SXM = "NVIDIA H100 80GB HBM3"
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"tf32": 495e12, "f32": 67e12,  # tensor cores; f32 CUDA cores
                # 32-bit integer operations: an SM's four schedulers dispatch at
                # most 128 lane operations a clock, the f32 rate without the
                # FMA's second operation (integer adds and shifts run on the
                # FMA pipe too, not on the 64 INT32 lanes alone)
                "int32": 67e12 / 2}
# the integer operations one noise element needs: a threefry2x32 (2 key
# adds, 20 rounds of add, rotate and xor, 5 injections of 2 adds) and the
# xor of its two words; the split of the key is once a call
THREEFRY_OPS = 2 + 20 * 3 + 5 * 2 + 1

ATTENTION_SHAPES = [  # (B, N, H, D, dtype, n_valid)
    (35, 577, 16, 64, "bf16", None),   # patch ViT, the hot shape
    (35, 577, 16, 64, "f32", None),    # patch ViT under --dtype f32
    (1, 577, 16, 64, "f32", None),     # FOV ViT (f32 under every dtype)
    (1, 577, 16, 64, "f32", 500),      # the same, keys past n_valid masked
    (1, 1025, 16, 64, "f32", None),    # FOV ViT of a vit_img_size 512 checkpoint
    (1, 577, 16, 64, "bf16", None),    # image ViT
    (1, 577, 16, 64, "bf16", 500),     # keys past n_valid masked
    (35, 1025, 16, 64, "bf16", None),  # vit_img_size 512: K and V stream through the ring
    (2, 1025, 16, 64, "bf16", 1000),   # the same, few heads: idle warpgroups in a round
    (2, 1700, 4, 32, "bf16", 1650),    # MID heads past the 1536 keys kept whole
    (3, 70, 2, 8, "f32", None),        # TINY heads, ragged N
    (35, 65, 4, 32, "f32", None),      # MID heads
    (2, 130, 4, 32, "bf16", 100),      # MID heads, ragged N, masked
    (140, 577, 16, 64, "bf16", None),  # patch ViT of a batch of four photos
    (4, 577, 16, 64, "f32", None),     # FOV ViT of a batch of four photos
    (140, 577, 16, 64, "f32", None),   # patch ViT of a batch of four under --dtype f32
    (35, 577, 16, 64, "f16", None),    # patch ViT under --dtype f16
    (1, 577, 16, 64, "f16", None),     # image ViT under --dtype f16
    (1, 577, 16, 64, "f16", 500),      # the same, keys past n_valid masked
    (3, 70, 2, 8, "f16", None),        # TINY heads (CUDA cores), ragged N
    (8, 2443, 16, 64, "bf16", None),   # DAv2, eight 1080p frames: the streamed K/V ring
    (1, 1814, 16, 64, "bf16", None),   # DAv2, one 12 MP photo (518x686, a 37x49 grid)
]
# per-shard attention shapes of the sharded meshes: (B, N, H, D, dtype, n_valid)
PER_SHARD_ATTENTION = [
    (35, 577, 8, 64, "bf16", None),   # patch ViT at 1x2 (model 2: 8 heads a rank)
    (18, 577, 16, 64, "bf16", None),  # patch ViT at 2x1 (36 patches, 18 a rank)
    (18, 577, 8, 64, "bf16", None),   # patch ViT at 2x2
    (35, 577, 4, 64, "bf16", None),   # patch ViT at 1x4
    (1, 577, 8, 64, "bf16", None),    # image ViT under model 2
    (1, 577, 8, 64, "f32", None),     # FOV ViT under model 2 (f32)
]
ATTENTION_SHAPES += PER_SHARD_ATTENTION
# a sharded forward's wall budget, seconds (gloo moves the f32 partial
# products through host memory: ~4 GB a forward at 1x2)
MESH_TIMEOUT = 300.0
FLASH_SHAPES = [  # (B, H, N, D, dtype, n_valid, permuted views of one qkv buffer)
    (35, 16, 577, 64, "bf16", None, True),  # the patch ViT's shape
    (35, 16, 577, 64, "f32", None, True),   # the same under --dtype f32
    (1, 16, 577, 64, "bf16", 500, False),   # keys past n_valid masked
    (2, 4, 130, 32, "bf16", 100, False),    # MID heads, ragged N, masked
    (2, 16, 1025, 64, "bf16", 1000, False),  # K and V streamed, masked
    (3, 2, 70, 8, "f32", None, False),      # TINY heads, ragged N
    (35, 16, 577, 64, "f16", None, True),   # the patch ViT's shape under --dtype f16
]
LINKER_SHAPES = [  # (H, W, amplitude): pw and win follow from the geometry
    (3024, 4032, 1 / 16),   # 12 MP photo, default amplitude: pw 504, win 253
    (3024, 4032, 0.1),      # shifts over 255: pw 807, win 404
    (4536, 6048, 1 / 16),   # --resize-scale=1.5: pw 756, win 379
    (1, 300, 1 / 16),       # one row
    (130, 33, 0.45),        # W < pw + win, H not a multiple of anything
    (5, 20, 0.06),          # win == pw: one column per step
    (4, 20, 0.6),           # pw > W: noise only
    (3, 30000, 0.45),       # pw 27000: a 128 KB ring in shared memory
    (2, 64000, 0.45),       # pw 57600: the ring past shared memory, in device memory
]
THREEFRY_SHAPES = [  # the noise planes of a 4032x3024 photo's stereograms
    (3024, 807, 3),    # resolved PNG, amplitude 0.1: pw 807 (the summary's row)
    (3024, 504, 3),    # compact PNG and JPEG, amplitude 1/16: pw 504
    (3024, 4032, 3),   # full width (pw == 0 or the wide case)
    (7, 13, 3),        # 273 bytes: a ragged tail past 16-byte stores
]
THREEFRY_SEEDS = (0, -1, 2**31 + 3)
# the ViT block's elementwise chains, (kernel, shape, dtypes, timed): GELU on
# the (tokens, 4096) hidden, the residual's x, o and ls on (tokens, 1024)
VIT_ELEMENTWISE_SHAPES = [
    ("gelu", (140, 577, 4096), ("bf16",), True),   # patch ViT, a batch of four
    ("gelu", (35, 577, 4096), ("bf16",), True),    # patch ViT, one photo
    ("gelu", (4, 577, 4096), ("bf16",), True),     # image ViT, a batch of four
    ("gelu", (4, 577, 4096), ("f32",), True),      # FOV ViT (f32 under every policy)
    ("gelu", (35, 577, 4096), ("f16",), True),     # patch ViT under --dtype f16
    ("gelu", (3, 7, 37), ("bf16",), False),        # 777 elements: a tail past the chunks
    ("scaled_residual", (140, 577, 1024), ("f32", "bf16", "bf16"), True),  # bf16, int8
    ("scaled_residual", (140, 577, 1024), ("f32", "bf16", "f32"), True),   # mixed
    ("scaled_residual", (35, 577, 1024), ("f32", "bf16", "bf16"), True),   # one photo
    ("scaled_residual", (4, 577, 1024), ("f32", "f32", "f32"), True),      # FOV ViT
    ("scaled_residual", (35, 577, 1024), ("f32", "f16", "f16"), True),     # --dtype f16
    ("scaled_residual", (3, 7, 16), ("bf16", "bf16", "bf16"), False),  # no f32 residual
    ("scaled_residual", (5, 3, 24), ("f16", "bf16", "f32"), False),   # mixed dtypes, ragged rows
    ("gelu", (8, 2443, 4096), ("bf16",), True),    # DAv2, eight 1080p frames
    ("scaled_residual", (8, 2443, 1024), ("f32", "bf16", "bf16"), True),  # the same
]
# (B, H, W, Cin, Cout, dtype, relu_in, n_skips, bias, launches per DEPTH_PRO
# forward or None): every distinct conv of the forward (4 projections, 18
# residual-unit convs, the head's 2) in bf16, in f32 (--dtype f32 and the
# mixed policy) and in f16 (--dtype f16), then shapes off the main path.
# The launches column is what the depth-map run of that dtype must show, shape by shape (conv3x3's in the launch ledger); the
# per-forward sums weight by that count.
_FORWARD_CONVS = [  # (H, W, Cin, Cout, relu_in, n_skips, bias, launches)
    (768, 768, 256, 256, True, 2, True, 1),    # fused RCU, the hot shape
    (768, 768, 256, 256, True, 1, True, 1),    # RCU conv2, one residual
    (768, 768, 256, 256, True, 0, True, 2),    # RCU conv1
    (768, 768, 256, 128, False, 0, True, 1),   # head conv0
    (768, 768, 136, 128, False, 0, True, 1),   # head's composed conv
    (384, 384, 256, 256, False, 0, False, 1),  # projection
    (384, 384, 256, 256, True, 2, True, 1),
    (384, 384, 256, 256, True, 1, True, 1),
    (384, 384, 256, 256, True, 0, True, 2),
    (192, 192, 512, 256, False, 0, False, 1),  # projection
    (192, 192, 256, 256, True, 2, True, 1),
    (192, 192, 256, 256, True, 1, True, 1),
    (192, 192, 256, 256, True, 0, True, 2),
    (96, 96, 1024, 256, False, 0, False, 1),   # projection
    (96, 96, 256, 256, True, 2, True, 1),
    (96, 96, 256, 256, True, 1, True, 1),
    (96, 96, 256, 256, True, 0, True, 2),
    (48, 48, 1024, 256, False, 0, False, 1),   # projection, K = 9216
    (48, 48, 256, 256, True, 1, True, 1),
    (48, 48, 256, 256, True, 0, True, 1),
]
CONV_SHAPES = [(1, H, W, cin, cout, dt, relu_in, n_skips, bias, launches)
               for dt in ("bf16", "f32", "f16")
               for H, W, cin, cout, relu_in, n_skips, bias, launches in _FORWARD_CONVS] + [
    (2, 7, 9, 8, 4, "f32", True, 1, True, None),          # TINY channels, odd sizes
    (2, 7, 9, 12, 5, "bf16", True, 2, True, None),        # odd channels: padded to 8
    (1, 5, 3, 129, 128, "f32", False, 0, True, None),     # 129 channels, tiny grid
    (4, 768, 768, 256, 256, "bf16", True, 2, True, None),  # a batch of four: the hot shape
    (4, 96, 96, 256, 256, "bf16", True, 2, True, None),    # and the 96^2 RCU
    (4, 768, 768, 256, 256, "f32", True, 2, True, None),   # the hot shape of four, --dtype f32
    (15, 768, 768, 256, 256, "bf16", True, 0, True, None),  # past 2^31 elements (64-bit offsets)
]
# Depth Anything V2 Large's DPT head on a batch of eight 1920x1080 frames
# (518x924 in, a 37x66 patch grid; levels 148x264, 74x132, 37x66, 19x33):
# (H, W, Cin, Cout, relu_in, n_skips, bias, launches per forward), checked
# by phase 20. Their CONV_SHAPES rows carry no launches: phases 4-5 hold
# DEPTH_PRO's forward to that column.
DAV2_BATCH = 8
DAV2_CONVS = [
    (148, 264, 256, 256, False, 0, False, 1),   # layer1_rn
    (74, 132, 512, 256, False, 0, False, 1),    # layer2_rn
    (37, 66, 1024, 256, False, 0, False, 1),    # layer3_rn
    (19, 33, 1024, 256, False, 0, False, 1),    # layer4_rn
    (148, 264, 256, 256, True, 0, True, 2),     # refinenet1's units, conv1
    (148, 264, 256, 256, True, 2, True, 1),     # resConfUnit1's conv2 + the skip input
    (148, 264, 256, 256, True, 1, True, 1),     # resConfUnit2's conv2
    (74, 132, 256, 256, True, 0, True, 2),      # refinenet2
    (74, 132, 256, 256, True, 2, True, 1),
    (74, 132, 256, 256, True, 1, True, 1),
    (37, 66, 256, 256, True, 0, True, 2),       # refinenet3
    (37, 66, 256, 256, True, 2, True, 1),
    (37, 66, 256, 256, True, 1, True, 1),
    (19, 33, 256, 256, True, 0, True, 1),       # refinenet4: resConfUnit2 alone
    (19, 33, 256, 256, True, 1, True, 1),
    (296, 528, 256, 128, False, 0, True, 1),    # output_conv1
    (518, 924, 128, 32, False, 0, True, 1),     # output_conv2's 3x3
]
CONV_SHAPES += [(DAV2_BATCH, H, W, cin, cout, "bf16", relu_in, n_skips, bias, None)
                for H, W, cin, cout, relu_in, n_skips, bias, _n in DAV2_CONVS]
# the forward's bilinear resamplings, (B, H, W, C, out_h, out_w): the four
# fusion blocks' 2x and the head's to the input's size; phase 20 counts
# them, phase 21 holds each against F.interpolate
DAV2_RESAMPLES = [
    (DAV2_BATCH, 19, 33, 256, 37, 66),
    (DAV2_BATCH, 37, 66, 256, 74, 132),
    (DAV2_BATCH, 74, 132, 256, 148, 264),
    (DAV2_BATCH, 148, 264, 256, 296, 528),
    (DAV2_BATCH, 296, 528, 128, 518, 924),
]
# (B, H, W, C, out_h, out_w, dtype, storage offset in elements, timed)
RESAMPLE_SHAPES = [(*s, "bf16", 0, True) for s in DAV2_RESAMPLES] + [
    (DAV2_BATCH, 296, 528, 128, 518, 924, "f32", 0, True),   # --dtype f32, the mixed decoder
    (DAV2_BATCH, 148, 264, 256, 296, 528, "f16", 0, True),   # --dtype f16
    (DAV2_BATCH, 19, 33, 256, 37, 66, "f32", 0, False),
    (DAV2_BATCH, 37, 66, 256, 74, 132, "f16", 0, False),
] + [(*s, dt, 0, False) for dt in ("bf16", "f32", "f16") for s in (
    (2, 7, 9, 24, 31, 5),      # up in H, down in W; 24 channels: f32 16-byte vectors only
    (2, 11, 13, 16, 4, 6),     # down in both
    (3, 5, 7, 3, 17, 29),      # 3 channels: PyTorch's NCHW kernel
    (2, 13, 17, 8, 13, 40),    # 8 channels: NCHW, 16-byte vectors
    (2, 13, 17, 20, 13, 40),   # 20: one element a lane
    (1, 9, 9, 20, 1, 1),       # an output of one pixel
    (2, 1, 1, 32, 5, 7),       # an input of one pixel
    (1, 6, 10, 64, 1, 19),     # one output row
    (2, 4, 5, 16, 4, 5),       # the same size: a copy
)] + [
    (2, 37, 66, 256, 74, 132, "bf16", 1, False),   # a view 2 bytes past 16-byte alignment
]
UPLOAD_SHAPES = ((3024, 4032, 3), (1080, 1920, 3))  # a 12 MP photo, a 1080p frame
UPLOAD_REPS = 40
# (keys, head dim, dtype, the K/V path the attention library reports)
KV_PATH_CASES = [
    (577, 64, "bf16", "resident"),    # Depth Pro's ViTs
    (2443, 64, "bf16", "streamed"),   # Depth Anything V2 at 1080p
    (640, 64, "bf16", "resident"), (641, 64, "bf16", "streamed"),
    (1536, 32, "f16", "resident"), (1537, 32, "f16", "streamed"),
    (577, 64, "f32", "streamed"),     # the 3xTF32 kernel's rings
    (70, 8, "bf16", "cuda_cores"),
]


# the ports of the JAX package's kernels, and threefry, by their names in the launch ledger
KERNELS = ("attention_qkv", "conv3x3", "linker_scan", "attention_flash", "threefry")


def counted_run(fn):
    """Run fn with the launch ledger (``ops._build``) cleared just before
    it; return its result, the counts just after ({kernel: launches}) and
    conv3x3's launches by shape ({(B, H, W, Cin, Cout, dtype, relu_in,
    residuals, bias): launches}). The ledger keeps every kernel's launches
    by key until the next run (``launches_by``)."""
    import torch

    from matrix_eyes_tpu_torch.ops import _build

    _build.reset()
    result = fn()
    torch.cuda.synchronize()
    return (result, {name: _build.launches(name).total() for name in KERNELS},
            dict(_build.launches("conv3x3")))


def launches_by(kernel: str, index: int | None = None) -> dict:
    """``kernel``'s launches in the ledger by key, or by the key's item at
    ``index`` (attention_qkv: 0 the batch, 4 the dtype)."""
    from matrix_eyes_tpu_torch.ops import _build

    counts = _build.launches(kernel)
    if index is None:
        return dict(counts)
    by = collections.Counter()
    for key, n in counts.items():
        by[key[index]] += n
    return dict(by)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(got, ref, dtype) -> dict:
    """Errors of got against ref (max_rel_err: max |err| over max |ref|),
    and whether they are within the stated tolerance for dtype."""
    import torch

    max_abs = max_ref = 0.0
    ok = True
    # a tensor past 2^28 elements is compared a slice of its first axis at a
    # time, so that its f32 copies stay small
    for g, r in zip(got, ref) if got.numel() > 2**28 else [(got, ref)]:
        g, r = g.float(), r.float()
        err = (g - r).abs()
        max_abs = max(max_abs, err.max().item())
        max_ref = max(max_ref, r.abs().max().item())
        ok = ok and bool(torch.isfinite(g).all())
        if dtype == torch.float32:
            ok = ok and bool((err <= F32_ATOL + F32_RTOL * r.abs()).all())
    if dtype != torch.float32:
        ok = ok and max_abs <= (F16_REL if dtype == torch.float16 else BF16_REL) * max_ref
    return {"max_abs_err": max_abs, "max_rel_err": max_abs / max(max_ref, 1e-30),
            "max_ref": max_ref, "ok": ok}


def phase_environment() -> str:
    import torch

    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    cap = torch.cuda.get_device_capability(0)
    print(f"[1] device {name}, capability {cap}, count {torch.cuda.device_count()}")
    print(f"[1] nvidia-smi: {smi}")
    require(cap == (9, 0), f"expected a Hopper card (capability (9, 0)), got {cap}")
    from matrix_eyes_tpu_torch.native import lanczos, pngwriter

    try:
        import PIL  # noqa: F401
        has_pil = True
    except ImportError:
        has_pil = False
    print(f"[1] PIL {has_pil}, native pngwriter {pngwriter.available()}, "
          f"native lanczos {lanczos.available()}")
    return smi


_NEW_KERNELS = ("conv3x3_wgmma_kernel", "conv3x3_tf32_kernel", "conv3x3_split_weights",
                "conv3x3_splitk_reduce", "attention_wgmma_kernel", "attention_tf32_kernel",
                "split_tf32_kernel", "linker_scan_kernel", "randint_u8_kernel",
                "vit_gelu_kernel", "vit_scaled_residual_kernel", "resample_bilinear_kernel")
# template arguments as the mangled names spell them
_MANGLED_ARGS = r"L[ib](\d+)E|13__nv_bfloat16|6__half|f"


def _ptxas_lines(report: str) -> list:
    """ptxas's registers, barriers and spills for the tensor-core kernels,
    one line each, with the template arguments read off the mangled name."""
    import re

    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            base = next((k for k in _NEW_KERNELS if k in mangled), None)
            name = None
            if base:
                rest = mangled.split(base, 1)[1]
                args = [m.group(1) or {"f": "float", "6__half": "f16"}.get(m.group(0), "bf16")
                        for m in re.finditer(_MANGLED_ARGS, rest.split("EEv", 1)[0])
                        ] if rest.startswith("I") else []
                name = base + (f"<{', '.join(args)}>" if args else "")
                spill = ""
            continue
        if name and "spill stores" in line:
            spill = line.strip()
        elif name and line.strip().startswith("ptxas info    : Used"):
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def phase_build():
    import ctypes

    from matrix_eyes_tpu_torch.ops import _build

    t0 = time.perf_counter()
    names = ["attention_qkv", "conv3x3", "linker_scan", "threefry", "vit_elementwise",
             "resample"]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        paths = list(pool.map(_build.library_path, names))
    print(f"[2] built {', '.join(os.path.basename(p) for p in paths)} "
          f"in {time.perf_counter() - t0:.1f} s")
    for name in ("conv3x3", "attention_qkv", "linker_scan", "threefry", "vit_elementwise",
                 "resample"):
        for line in _ptxas_lines(_build.ptxas_report(name)):
            print(f"[2] ptxas {line}")
        require("C7514" not in _build.ptxas_report(name),
                f"ptxas serialized a wgmma pipeline of {name} (warning C7514)")
    conv = ctypes.CDLL(paths[1])
    attn = ctypes.CDLL(paths[0])
    scan = ctypes.CDLL(paths[2])
    print(f"[2] dynamic shared memory per block: conv3x3_wgmma_kernel<256> "
          f"{conv.me_conv3x3_smem_bytes(256, 1)} B, <128> {conv.me_conv3x3_smem_bytes(128, 1)} B; "
          f"conv3x3_tf32_kernel {conv.me_conv3x3_smem_bytes(128, 0)} B; "
          f"attention_wgmma_kernel<64> at 577 keys {attn.me_attention_smem_bytes(64, 577, 1)} B, "
          f"<32> at 577 keys {attn.me_attention_smem_bytes(32, 577, 1)} B; streamed K/V ring "
          f"<64> at 1025 keys {attn.me_attention_smem_bytes(64, 1025, 1)} B; "
          f"attention_tf32_kernel<64> {attn.me_attention_smem_bytes(64, 577, 0)} B, "
          f"<32> {attn.me_attention_smem_bytes(32, 577, 0)} B; linker_scan_kernel at 4032 "
          f"columns pw 504 {scan.me_linker_scan_smem_bytes(4032, 504)} B, 30000 columns pw "
          f"27000 {scan.me_linker_scan_smem_bytes(30000, 27000)} B")
    sass = sass_instructions(paths[3], "randint_u8_kernel")
    if sass is None:
        print("[2] threefry SASS: cuobjdump not found beside nvcc, not counted")
    else:
        print(f"[2] threefry randint_u8_kernel SASS: {sum(sass.values())} instructions in the "
              f"code of a thread's 16 elements, the tail's byte stores included "
              f"({sum(sass.values()) / 16:.1f} an element, against {THREEFRY_OPS} counted in "
              f"the bound): {dict(sass.most_common())}")
    return sass


def sass_instructions(lib_path: str, kernel: str):
    """The SASS opcodes of ``kernel`` in the library (cuobjdump beside
    nvcc), counted by opcode without NOPs; None without cuobjdump. The
    threefry kernel's loops are unrolled, so this is one thread's code."""
    import collections
    import re

    from matrix_eyes_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    ops, inside = collections.Counter(), False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and m and m.group(1) != "NOP":
            ops[m.group(1)] += 1
    require(sum(ops.values()) > 0, f"cuobjdump shows no SASS for {kernel}")
    return ops


def peak_flops_s(dt: str) -> float:
    """The H100 SXM's dense peak for dt, FLOP/s; bf16 and f16 from the
    port's FLOP ledger."""
    from matrix_eyes_tpu_torch.flops import _PEAKS

    return _PEAKS[H100_SXM] if dt in ("bf16", "f16") else PEAK_FLOPS_S[dt]


def bound_ms(flops: float, nbytes: float, dt: str) -> tuple:
    """(least ms, what bounds it): the larger of bytes over the memory rate
    and FLOPs over the peak rate for dt."""
    t_ops = flops / peak_flops_s(dt) * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from matrix_eyes_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
    from matrix_eyes_tpu_torch.ops.flash_attention import (
        attention_flash,
        attention_flash_plain,
        attention_qkv,
        attention_qkv_plain,
    )
    from matrix_eyes_tpu_torch.ops.stereogram import _max_shift, stereogram_geometry
    from matrix_eyes_tpu_torch.ops.stereogram_kernel import linker_scan, linker_scan_plain

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
    gen = torch.Generator(device=dev).manual_seed(1234)
    hot = {}
    failures = []

    def put_bound(res, flops, nbytes, dt):
        """bound_ms and bound_by into res; for f32 the least time at f32
        accuracy on the tensor cores (three TF32 products) and, beside it,
        one f32 product on the CUDA cores (bound_cuda_core_ms)."""
        if dt != "f32":
            res["bound_ms"], res["bound_by"] = bound_ms(flops, nbytes, dt)
        else:
            res["bound_ms"], res["bound_by"] = bound_ms(3 * flops, nbytes, "tf32")
            res["bound_cuda_core_ms"] = bound_ms(flops, nbytes, "f32")[0]

    def attention_bound(res, B, N, H, D, dt, n_valid):
        nv = N if n_valid is None else n_valid
        e = 4 if dt == "f32" else 2
        # q and o over N rows, k and v over the n_valid keys that count
        put_bound(res, 4.0 * B * H * N * nv * D, (2 * N + 2 * nv) * B * H * D * e, dt)

    def bound_text(res):
        extra = (f", CUDA cores {res['bound_cuda_core_ms']:.4f}" if "bound_cuda_core_ms" in res
                 else "")
        return f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}{extra})"

    def sdpa_ms(q, k, v, scale, n_valid, reps):
        nv = q.shape[2] if n_valid is None else n_valid
        k, v = k[:, :, :nv].contiguous(), v[:, :, :nv].contiguous()
        return time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), reps)

    for B, N, H, D, dt, n_valid in ATTENTION_SHAPES:
        dtype = dtypes[dt]
        qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=gen).to(dtype)
        scale = D ** -0.5
        res = compare(attention_qkv(qkv, H, scale, n_valid),
                      attention_qkv_plain(qkv, H, scale, n_valid), dtype)
        reps = 10 if B * N > 1000 else 50
        res["ms"] = time_ms(lambda: attention_qkv(qkv, H, scale, n_valid), reps)
        res["plain_ms"] = time_ms(lambda: attention_qkv_plain(qkv, H, scale, n_valid), reps)
        q, k, v = (t.contiguous() for t in qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4))
        res["library_ms"] = sdpa_ms(q, k, v, scale, n_valid, reps)
        attention_bound(res, B, N, H, D, dt, n_valid)
        res["shape"] = f"B={B} N={N} H={H} D={D} {dt} n_valid={n_valid}"
        if (B, N, dt, n_valid) == (35, 577, "bf16", None):
            hot["attention_qkv"] = res
        if (B, N, dt, n_valid) == (1, 577, "f32", None):
            hot["attention_qkv_fov_f32"] = res
        if (B, N, dt, n_valid) == (140, 577, "bf16", None):
            hot["attention_qkv_batch4"] = res
        if (B, N, dt, n_valid) == (4, 577, "f32", None):
            hot["attention_qkv_batch4_fov_f32"] = res
        if (B, N, dt, n_valid) == (140, 577, "f32", None):
            hot["attention_qkv_batch4_f32"] = res
        if (B, N, dt, n_valid) == (35, 577, "f16", None):
            hot["attention_qkv_f16"] = res
        if (B, N, H, D, dt, n_valid) in PER_SHARD_ATTENTION:
            hot.setdefault("attention_qkv_per_shard", []).append(res)
        print(f"[3] attention {res['shape']}: max_abs={res['max_abs_err']:.3e} "
              f"max_rel={res['max_rel_err']:.3e} max_ref={res['max_ref']:.3e} "
              f"ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
              f"library_ms(sdpa)={res['library_ms']:.4f} {bound_text(res)} "
              f"{'ok' if res['ok'] else 'FAIL'}")
        if not res["ok"]:
            failures.append(f"attention {B, N, H, D, dt, n_valid}")
    for B, H, N, D, dt, n_valid, views in FLASH_SHAPES:
        dtype = dtypes[dt]
        if views:
            qkv = torch.randn(B, N, 3 * H * D, device=dev, generator=gen).to(dtype)
            q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
        else:
            q, k, v = (torch.randn(B, H, N, D, device=dev, generator=gen).to(dtype)
                       for _ in range(3))
        scale = D ** -0.5
        res = compare(attention_flash(q, k, v, scale, n_valid),
                      attention_flash_plain(q, k, v, scale, n_valid), dtype)
        reps = 10 if B * N > 1000 else 50
        res["ms"] = time_ms(lambda: attention_flash(q, k, v, scale, n_valid), reps)
        res["plain_ms"] = time_ms(lambda: attention_flash_plain(q, k, v, scale, n_valid), reps)
        res["library_ms"] = sdpa_ms(q.contiguous(), k.contiguous(), v.contiguous(), scale,
                                    n_valid, reps)
        attention_bound(res, B, N, H, D, dt, n_valid)
        res["shape"] = f"B={B} H={H} N={N} D={D} {dt} n_valid={n_valid} views={views}"
        if views and dt != "f32":
            hot["attention_flash" + ("_f16" if dt == "f16" else "")] = res
        print(f"[3] attention_flash {res['shape']}: max_abs={res['max_abs_err']:.3e} "
              f"max_rel={res['max_rel_err']:.3e} max_ref={res['max_ref']:.3e} "
              f"ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
              f"library_ms(sdpa)={res['library_ms']:.4f} {bound_text(res)} "
              f"{'ok' if res['ok'] else 'FAIL'}")
        if not res["ok"]:
            failures.append(f"attention_flash {B, H, N, D, dt, n_valid}")
    for H, W, amplitude in LINKER_SHAPES:
        dm, pw = stereogram_geometry(W, amplitude)
        win = _max_shift(dm) + 1
        u = torch.rand(H, W, device=dev, generator=gen)
        shift = torch.floor(u * dm + 0.5).to(torch.int32)
        noise = torch.randint(0, 256, (H, pw, 3), device=dev, generator=gen, dtype=torch.uint8)
        got = linker_scan(shift, noise, pw, win)
        want = linker_scan_plain(shift, noise, pw, win)
        torch.cuda.synchronize()
        err = (got.int() - want.int()).abs().max().item()
        res = {"max_abs_err": float(err), "ok": bool(torch.equal(got, want))}
        reps = 10 if H * W > 100_000 else 50
        res["ms"] = time_ms(lambda: linker_scan(shift, noise, pw, win), reps)
        res["plain_ms"] = time_ms(lambda: linker_scan_plain(shift, noise, pw, win), reps)
        res["library_ms"] = None  # no PyTorch call computes the scan
        # int32 shifts and u8 noise read, u8 RGB written; no arithmetic to speak of
        res["bound_ms"], res["bound_by"] = bound_ms(0.0, H * W * 4 + H * pw * 3 + H * W * 3,
                                                    "bf16")
        res["shape"] = f"{H}x{W} amplitude={amplitude:g} pw={pw} win={win}"
        if (H, W, amplitude) == LINKER_SHAPES[0]:
            hot["linker_scan"] = res
        print(f"[3] linker_scan {res['shape']}: max_abs={err} ms={res['ms']:.4f} "
              f"plain_ms={res['plain_ms']:.4f} bound_ms={res['bound_ms']:.4f} "
              f"({res['bound_by']}) {'ok (bit-exact)' if res['ok'] else 'FAIL'}")
        if not res["ok"]:
            failures.append(f"linker_scan {H, W, amplitude}")
    for shape in THREEFRY_SHAPES:
        for seed in THREEFRY_SEEDS:
            res = threefry_row(dev, shape, seed, timed=seed == THREEFRY_SEEDS[0])
            if shape == THREEFRY_SHAPES[0] and seed == THREEFRY_SEEDS[0]:
                hot["threefry"] = res
            if seed == THREEFRY_SEEDS[0]:
                hot.setdefault("threefry_rows", []).append(res)
            if not res["ok"]:
                failures.append(f"threefry {shape} seed {seed}")
    conv_rows = {}
    for B, H, W, cin, cout, dt, relu_in, n_skips, has_bias, launches in CONV_SHAPES:
        dtype = dtypes[dt]
        x = torch.randn(B, H, W, cin, device=dev, generator=gen).to(dtype)
        w = (torch.randn(3, 3, cin, cout, device=dev, generator=gen) / (9 * cin) ** 0.5).to(dtype)
        b = torch.randn(cout, device=dev, generator=gen).to(dtype) if has_bias else None
        skips = [torch.randn(B, H, W, cout, device=dev, generator=gen).to(dtype)
                 for _ in range(n_skips)] + [None] * (2 - n_skips)
        res = compare(conv3x3(x, w, b, skips[0], skips[1], relu_in),
                      conv3x3_plain(x, w, b, skips[0], skips[1], relu_in), dtype)
        reps = 5 if H * W > 100_000 else 20
        res["ms"] = time_ms(lambda: conv3x3(x, w, b, skips[0], skips[1], relu_in), reps)
        res["plain_ms"] = time_ms(lambda: conv3x3_plain(x, w, b, skips[0], skips[1], relu_in),
                                  reps)
        xc = x.permute(0, 3, 1, 2)  # NHWC storage: the channels-last view
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        res["library_ms"] = time_ms(lambda: F.conv2d(xc, wc, b, padding=1), reps)
        e = 4 if dt == "f32" else 2
        m = B * H * W
        put_bound(res, 2.0 * m * 9 * cin * cout,
                  (m * cin + 9 * cin * cout + (cout if has_bias else 0) + (1 + n_skips) * m * cout)
                  * e, dt)
        res["shape"] = (f"{B}x{H}x{W} {cin}->{cout} {dt} relu_in={relu_in} skips={n_skips} "
                        f"bias={has_bias}")
        res["launches_per_forward"] = launches
        if (B, H, cin, cout, n_skips) == (1, 768, 256, 256, 2):
            hot[{"bf16": "conv3x3", "f32": "conv3x3_f32", "f16": "conv3x3_f16"}[dt]] = res
        if (B, H) == (4, 768):
            hot["conv3x3_batch4" if dt == "bf16" else "conv3x3_batch4_f32"] = res
        if B == 15:
            hot["conv3x3_past_2e31"] = res
        conv_rows[(B, H, W, cin, cout, dtype, relu_in, n_skips, has_bias)] = res
        print(f"[3] conv3x3 {res['shape']} x{launches or 0}/forward: "
              f"max_abs={res['max_abs_err']:.3e} max_rel={res['max_rel_err']:.3e} "
              f"max_ref={res['max_ref']:.3e} ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
              f"library_ms(F.conv2d)={res['library_ms']:.4f} {bound_text(res)} "
              f"{'ok' if res['ok'] else 'FAIL'}")
        if not res["ok"]:
            failures.append(f"conv3x3 {B, H, W, cin, cout, dt, n_skips}")
        del x, xc, skips
    torch.cuda.empty_cache()
    require(not failures, f"kernels disagree with their plain versions: {failures}")
    return hot, conv_rows


def threefry_row(dev, shape: tuple, seed: int, timed: bool) -> dict:
    """The noise kernel against its plain version at shape and seed, bit
    for bit; when ``timed``, its time by CUDA events and by the profiler,
    the plain version's, and the host draw plus upload that the kernel
    replaced (a seeded CPU ``torch.randint`` copied to the card)."""
    import torch

    from matrix_eyes_tpu_torch.ops.prng import key_tensor, randint_u8, randint_u8_plain
    from matrix_eyes_tpu_torch.parallel.checks import device_ms

    key = key_tensor(seed, dev)
    got = randint_u8(key, shape)
    want = randint_u8_plain(key, shape)
    torch.cuda.synchronize()
    n = got.numel()
    # library_ms: no PyTorch call draws these bits
    res = {"max_abs_err": float((got.int() - want.int()).abs().max().item()),
           "ok": bool(torch.equal(got, want)), "library_ms": None,
           "shape": f"{'x'.join(map(str, shape))} u8 seed={seed}"}
    # one byte written per element, the 16-byte key read once
    res["bound_ms"], res["bound_by"] = bound_ms(THREEFRY_OPS * n, n + 16, "int32")
    if timed:
        reps = 20 if n > 100_000 else 50
        res["ms"] = time_ms(lambda: randint_u8(key, shape), reps)
        res["device_ms"] = device_ms(lambda: randint_u8(key, shape), reps)[0]
        res["plain_ms"] = time_ms(lambda: randint_u8_plain(key, shape), 3 if n > 10**6 else reps)

        def host_draw():
            gen = torch.Generator("cpu").manual_seed(seed)
            return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(dev)

        host_draw()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host_draw()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        res["host_draw_upload_ms"] = sum(walls) / len(walls) * 1e3
    times = (f"ms={res['ms']:.4f} device_ms={res['device_ms']:.4f} "
             f"plain_ms={res['plain_ms']:.4f} host_draw_upload_ms="
             f"{res['host_draw_upload_ms']:.4f} " if timed else "")
    print(f"[3] threefry {res['shape']}: max_abs={res['max_abs_err']:g} {times}"
          f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) "
          f"{'ok (bit-exact)' if res['ok'] else 'FAIL'}")
    return res


def conv_per_forward(conv_rows: dict, by_shape: dict, dtype, phase: int) -> dict:
    """conv3x3's phase-3 times summed over one forward, each shape weighted
    by its launches in the depth-map run of dtype (by_shape, from
    counted_run); fails if the run launched a shape phase 3 did not time,
    or if the run's launches differ from CONV_SHAPES' column for dtype."""
    import torch

    untimed = [k for k in by_shape if k not in conv_rows]
    require(not untimed, f"the forward launched conv3x3 shapes phase 3 did not time: {untimed}")
    plan = {k: r["launches_per_forward"] for k, r in conv_rows.items()
            if r["launches_per_forward"] and k[5] == dtype}
    require(by_shape == plan, f"conv3x3 launches by shape {by_shape}, CONV_SHAPES says {plan}")
    keys = ["ms", "plain_ms", "library_ms", "bound_ms"]
    keys += ["bound_cuda_core_ms"] if dtype == torch.float32 else []
    per_forward = {"launches": sum(by_shape.values())}
    for key in keys:
        per_forward[key] = sum(n * conv_rows[k][key] for k, n in by_shape.items())
    for k, n in by_shape.items():
        print(f"[{phase}] conv3x3 {conv_rows[k]['shape']}: {n} launch(es) in the depth-map run")
    extra = (f", CUDA-core bound {per_forward['bound_cuda_core_ms']:.3f}"
             if "bound_cuda_core_ms" in per_forward else "")
    print(f"[{phase}] conv3x3 per DEPTH_PRO forward ({per_forward['launches']} launches, sum of "
          f"launches x phase-3 ms): kernel {per_forward['ms']:.3f} ms, plain "
          f"{per_forward['plain_ms']:.3f}, library {per_forward['library_ms']:.3f}, "
          f"bound {per_forward['bound_ms']:.3f}{extra}")
    return per_forward


def png_diff(a: str, b: str) -> tuple:
    """(mean, 99.9th percentile, max) of |a - b| in u8 counts over the
    pixels of two PNGs of one size (inf where the sizes differ)."""
    import numpy as np
    from PIL import Image

    with Image.open(a) as x, Image.open(b) as y:
        x, y = np.asarray(x.convert("RGB"), np.int16), np.asarray(y.convert("RGB"), np.int16)
    if x.shape != y.shape:
        return math.inf, math.inf, math.inf
    diff = np.abs(x - y)
    return float(diff.mean()), float(np.percentile(diff, 99.9)), int(diff.max())


def _png_size(path: str):
    with open(path, "rb") as f:
        head = f.read(24)
    require(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def depth_map_runs(dev, params, src, dtype, phase: int, name: str) -> tuple:
    """``pipeline.extract_depth`` to a depth-map PNG, twice, at DEPTH_PRO
    with params of dtype: launch counts and conv3x3's launches by shape of
    each run (equal between runs, every conv in dtype), a 4032x3024 PNG, a
    finite inverse depth and FOV. Returns the first run's counts and shapes,
    and the inverse depth."""
    import torch

    from matrix_eyes_tpu_torch import pipeline
    from matrix_eyes_tpu_torch.config import DEPTH_PRO, RuntimeConfig
    from matrix_eyes_tpu_torch.models import depth_pro

    cfg = DEPTH_PRO
    runtime = RuntimeConfig(device=dev, dtype=dtype)
    os.makedirs(OUT_DIR, exist_ok=True)
    out_png = os.path.join(OUT_DIR, f"chip_smoke_{name}.png")
    walls, counts, conv_shapes = [], [], []
    for _ in range(2):
        t0 = time.perf_counter()
        _, c, shapes = counted_run(lambda: pipeline.extract_depth(
            cfg, params, "synthetic-3024x4032", out_png, runtime=runtime, source=src))
        walls.append(time.perf_counter() - t0)
        counts.append(c)
        conv_shapes.append(shapes)
    print(f"[{phase}] extract_depth ({name}) wall s: first {walls[0]:.3f}, second (captures "
          f"its graphs) {walls[1]:.3f}; launches per run: {counts}")
    # 72 ViT blocks; 18 RCU + 4 projection + 2 head convs; no scan or noise on this path
    expect = {"attention_qkv": 3 * cfg.depth, "conv3x3": 24, "linker_scan": 0,
              "attention_flash": 0, "threefry": 0}
    require(all(c == expect for c in counts),
            f"launch counts {counts}, expected {expect} per forward")
    require(conv_shapes[0] == conv_shapes[1], f"conv3x3 shapes differ between runs: {conv_shapes}")
    require(all(k[5] == dtype for k in conv_shapes[0]),
            f"conv3x3 launches of another dtype than {dtype}: {list(conv_shapes[0])}")
    size = _png_size(out_png)
    print(f"[{phase}] {out_png}: {size[0]}x{size[1]}, {os.path.getsize(out_png)} bytes")
    require(size == (4032, 3024), f"depth map PNG is {size}, expected 4032x3024")

    img = pipeline.preprocess_image(src.rgb, cfg.img_size, dtype, dev)
    inv, fov_deg = depth_pro.forward_with_fov(cfg, params, img)
    require(tuple(inv.shape) == (1, cfg.img_size, cfg.img_size), f"inverse depth {inv.shape}")
    require(bool(torch.isfinite(inv).all()) and bool(torch.isfinite(fov_deg).all()),
            "non-finite inverse depth or FOV")
    print(f"[{phase}] inverse depth {tuple(inv.shape)} finite, range [{inv.min().item():.4g}, "
          f"{inv.max().item():.4g}], fov {fov_deg.item():.4f} deg; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts[0], conv_shapes[0], inv


def synthetic_photo():
    """The phase-4 photo: a seeded 4032x3024 gradient with noise, no focal
    length (a ``SourceImage``)."""
    import numpy as np

    from matrix_eyes_tpu_torch.io.image import SourceImage

    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:3024, 0:4032]
    rgb = np.stack([xx * 255 // 4031, yy * 255 // 3023, (xx + yy) * 255 // 7054], -1)
    rgb = (rgb + rng.randint(-20, 21, rgb.shape)).clip(0, 255).astype(np.uint8)
    return SourceImage(rgb=rgb, original_size=(4032, 3024), focal_length_35mm=None)


def print_ledger(dev) -> None:
    """The port's logical FLOP ledger of one DEPTH_PRO photo, stage by
    stage, with and without the FOV head, and the card's dense bf16 peak,
    looked up by its exact name."""
    import torch

    from matrix_eyes_tpu_torch import flops
    from matrix_eyes_tpu_torch.config import DEPTH_PRO

    fov, no_fov = flops.model_flops(DEPTH_PRO), flops.model_flops(DEPTH_PRO, with_fov=False)
    print("[4] logical FLOP ledger of one DEPTH_PRO photo (matrix_eyes_tpu_torch.flops), "
          "TFLOP with / without the FOV head:")
    for stage, v in fov.items():
        without = f"{no_fov[stage] / 1e12:.4f}" if stage in no_fov else "-"
        print(f"[4]   {stage:<15} {v / 1e12:.4f} / {without}")
    name = torch.cuda.get_device_name(dev)
    peak = flops.device_peak_flops(dev)
    print(f"[4] dense bf16 peak of {name!r}: "
          + (f"{peak / 1e12:.0f} TFLOP/s" if peak else "none in flops._PEAKS, MFU not reported"))


def phase_main_path(dev) -> tuple:
    import torch

    from matrix_eyes_tpu_torch.config import DEPTH_PRO, RuntimeConfig
    from matrix_eyes_tpu_torch.models.init import init_params

    dtype = RuntimeConfig(device=dev).resolved_dtype()
    require(dtype == torch.bfloat16, f"default dtype on CUDA should be bf16, got {dtype}")
    t0 = time.perf_counter()
    params = init_params(DEPTH_PRO, torch.Generator(device=dev).manual_seed(0), dev, dtype)
    torch.cuda.synchronize()
    print(f"[4] random DEPTH_PRO weights on the card in {time.perf_counter() - t0:.1f} s")
    print_ledger(dev)
    src = synthetic_photo()
    counts, conv_shapes, inv = depth_map_runs(dev, params, src, dtype, 4, "depthmap")
    return counts, conv_shapes, inv, params, src


def phase_f32_path(dev, src) -> tuple:
    """The depth-map path under --dtype f32: f32 weights from phase 4's
    seed, the phase-4 photo. Returns the first run's counts, conv3x3's
    launches by shape and the inverse depth."""
    import torch

    from matrix_eyes_tpu_torch.config import DEPTH_PRO
    from matrix_eyes_tpu_torch.models.init import init_params

    torch.cuda.reset_peak_memory_stats()
    params = init_params(DEPTH_PRO, torch.Generator(device=dev).manual_seed(0), dev,
                         torch.float32)
    result = depth_map_runs(dev, params, src, torch.float32, 5, "depthmap_f32")
    del params
    torch.cuda.empty_cache()
    return result


def phase_end_to_end(dev) -> None:
    import numpy as np
    import torch

    from matrix_eyes_tpu_torch.config import MID
    from matrix_eyes_tpu_torch.models import depth_pro
    from matrix_eyes_tpu_torch.models.init import init_params
    from matrix_eyes_tpu_torch.models.spec import tree_map

    cfg = MID
    cpu_params = init_params(cfg, torch.Generator().manual_seed(3), "cpu", torch.float32)
    gpu_params = tree_map(lambda _p, t: t.to(dev), cpu_params)
    img = np.random.RandomState(5).uniform(-1, 1, (1, cfg.img_size, cfg.img_size, 3))
    img = torch.from_numpy(img.astype(np.float32))
    inv_cpu, fov_cpu = depth_pro.forward_with_fov(cfg, cpu_params, img)
    inv_gpu, fov_gpu = depth_pro.forward_with_fov(cfg, gpu_params, img.to(dev))
    inv_gpu, fov_gpu = inv_gpu.cpu(), fov_gpu.cpu()
    fov_ok = bool(torch.allclose(fov_gpu, fov_cpu, rtol=E2E_RTOL, atol=0.0))
    # compare in canonical units (inverse depth x f_norm): random weights
    # make the FOV head estimate a tiny angle, whose 1/f_norm multiplies
    # every value (~1700x at this seed) and would put f32 noise above atol
    f_norm = math.tan(0.5 * fov_cpu.item() * math.pi / 180.0) / 0.5
    can_cpu, can_gpu = inv_cpu * f_norm, inv_gpu * f_norm
    err = (can_gpu - can_cpu).abs()
    ok = fov_ok and bool((err <= E2E_ATOL + E2E_RTOL * can_cpu.abs()).all())
    raw = (inv_gpu - inv_cpu).abs().max().item()
    print(f"[6] MID f32 card vs CPU: fov {fov_gpu.item():.6f} vs {fov_cpu.item():.6f} deg "
          f"(f_norm {f_norm:.4g}); inverse depth x f_norm max_abs={err.max().item():.3e} "
          f"(raw inverse depth max_abs={raw:.3e}) {'ok' if ok else 'FAIL'}")
    require(ok, "the port on the card disagrees with the port on the CPU at MID f32")


def _decode_rgb(path: str):
    import numpy as np
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def phase_stereogram(dev, params, src) -> dict:
    """The stereogram path at full DEPTH_PRO width; returns each run's
    launch counts ({path: {kernel: launches}}) from its first pass."""
    import numpy as np
    import torch

    from matrix_eyes_tpu_torch import pipeline
    from matrix_eyes_tpu_torch.config import DEPTH_PRO, RuntimeConfig
    from matrix_eyes_tpu_torch.output import png
    from matrix_eyes_tpu_torch.output.depthmap import ImageOutputFormat

    require(png.split_supported(), "the native PNG encoder is missing: no compact form")
    cfg = DEPTH_PRO
    runtime = RuntimeConfig(device=dev, seed=STEREO_SEED)
    runs = [  # (path, name, destination, amplitude, linker_scan launches)
        ("compact_png", "compact PNG", "chip_smoke_stereo_compact.png", 1 / 16, 0),
        ("resolved_png", "device-resolved PNG", "chip_smoke_stereo_resolved.png", 0.1, 1),
        ("jpeg", "JPEG", "chip_smoke_stereo.jpg", 1 / 16, 1),
    ]
    by_path = {}
    for path, name, fname, amplitude, want_scans in runs:
        out = os.path.join(OUT_DIR, fname)
        walls, counts = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            depth_map, c, _ = counted_run(lambda: pipeline.extract_depth(
                cfg, params, "synthetic-3024x4032", out,
                image_format=ImageOutputFormat.STEREOGRAM, stereo_amplitude=amplitude,
                runtime=runtime, source=src))
            walls.append(time.perf_counter() - t0)
            counts.append(c)
        by_path[path] = counts[0]
        print(f"[7] stereogram {name} (amplitude {amplitude:g}) wall s: first {walls[0]:.3f}, "
              f"second {walls[1]:.3f}; launches per run: {counts}; "
              f"{os.path.getsize(out)} bytes")
        expect = {"attention_qkv": 3 * cfg.depth, "conv3x3": 24, "linker_scan": want_scans,
                  "attention_flash": 0, "threefry": 1}  # one noise draw, in either form
        require(all(c == expect for c in counts),
                f"stereogram {name}: launch counts {counts}, expected {expect} per run")
        img = _decode_rgb(out)
        require(img.shape == (3024, 4032, 3), f"stereogram {name} decodes to {img.shape}")
        if fname.endswith(".png"):
            ref = depth_map.render_stereogram(None, amplitude, STEREO_SEED).cpu().numpy()
            same = bool(np.array_equal(img, ref))
            print(f"[7] {name}: decoded pixels equal the kernel's device-resolved render: "
                  f"{same}")
            require(same, f"stereogram {name}: PNG pixels differ from the device render")
    return by_path


def write_photos(src) -> list:
    """The phase-4 photo as a PNG and four seeded variants of it: mirrored,
    a JPEG with an EXIF focal length of 28 mm, portrait and cropped.
    Returns their paths, in the directory order."""
    import numpy as np
    from PIL import Image

    from matrix_eyes_tpu_torch.output import png

    d = os.path.join(OUT_DIR, "photos")
    os.makedirs(d, exist_ok=True)
    for name in os.listdir(d):
        os.remove(os.path.join(d, name))
    rng = np.random.RandomState(9)

    def noisy(rgb):
        return (rgb + rng.randint(-8, 9, rgb.shape)).clip(0, 255).astype(np.uint8)

    rgb = src.rgb
    h, w = rgb.shape[:2]
    exif = Image.Exif()
    exif[0xA405] = 28
    # the JPEG sorts into the first chunk of four, beside photos without a
    # focal length: that forward is the mixed one
    photos = (("p0_photo.png", rgb), ("p1_mirrored.png", noisy(rgb[:, ::-1])),
              ("p2_exif.jpg", noisy(np.roll(rgb, w // 6, axis=1))),
              ("p3_portrait.png", noisy(rgb.transpose(1, 0, 2))),
              ("p4_cropped.png", noisy(rgb[h // 10:h * 17 // 20, w // 8:w * 7 // 8])))
    paths = []
    for name, img in photos:
        paths.append(os.path.join(d, name))
        if name.endswith(".jpg"):
            Image.fromarray(img).save(paths[-1], quality=95, exif=exif)
        else:
            png.save_rgb(np.ascontiguousarray(img), paths[-1])
    return paths


def _mesh_counts(path: str) -> tuple:
    """(vertices, faces) as the file states them: the PLY header, or the
    OBJ's v and f lines."""
    with open(path, "rb") as f:
        data = f.read()
    if path.endswith(".ply"):
        header = data[:data.index(b"end_header\n")].decode()
        return tuple(int(header.split(f"element {e} ")[1].split("\n")[0])
                     for e in ("vertex", "face"))
    return tuple(data.count(b"\n" + k) + data.startswith(k) for k in (b"v ", b"f "))


def phase_mesh(dev, params, src, photo: str) -> dict:
    """The mesh path at full DEPTH_PRO width from the phase-4 photo on disk;
    returns the OBJ-with-vertex-colours run's launch counts."""
    import numpy as np

    from matrix_eyes_tpu_torch import pipeline
    from matrix_eyes_tpu_torch.config import DEPTH_PRO, RuntimeConfig
    from matrix_eyes_tpu_torch.native import meshwriter
    from matrix_eyes_tpu_torch.output import writers
    from matrix_eyes_tpu_torch.output.depthmap import DepthMap, VertexMode
    from matrix_eyes_tpu_torch.output.mesh import build_mesh

    require(meshwriter.available(), "the native OBJ serializer is missing")
    cfg = DEPTH_PRO
    runtime = RuntimeConfig(device=dev)
    expect = {"attention_qkv": 3 * cfg.depth, "conv3x3": 24, "linker_scan": 0,
              "attention_flash": 0, "threefry": 0}
    colors_counts = None
    for name, fname, mode in (("PLY plain", "mesh_plain.ply", VertexMode.PLAIN),
                              ("OBJ vertex-colors", "mesh_colors.obj", VertexMode.COLOR),
                              ("OBJ texture-coordinates", "mesh_tex.obj", VertexMode.TEXTURE)):
        out = os.path.join(OUT_DIR, fname)
        walls, counts = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            depth_map, c, _ = counted_run(lambda: pipeline.extract_depth(
                cfg, params, photo, out, vertex_mode=mode, runtime=runtime, source=src))
            walls.append(time.perf_counter() - t0)
            counts.append(c)
        require(all(c == expect for c in counts),
                f"mesh {name}: launch counts {counts}, expected {expect} per run")
        grid = depth_map.data.cpu().numpy()
        mesh = build_mesh(grid)
        stated = _mesh_counts(out)
        print(f"[8] mesh {name} wall s: first {walls[0]:.3f}, second {walls[1]:.3f}; launches "
              f"per run: {counts}; {os.path.getsize(out)} bytes; vertices, faces {stated} "
              f"(build_mesh {mesh.nvertices}, {mesh.nfaces})")
        require(stated == (mesh.nvertices, mesh.nfaces),
                f"mesh {name}: the file states {stated}, build_mesh gives "
                f"{(mesh.nvertices, mesh.nfaces)}")
        require(mesh.nfaces > 0, f"mesh {name}: no face kept")
        if mode == VertexMode.TEXTURE:
            mtl = os.path.join(OUT_DIR, "mesh_tex.mtl")
            with open(mtl) as f:
                require(f"map_Kd {photo}" in f.read(), "the .mtl does not name the photo")
        if mode == VertexMode.COLOR:
            colors_counts = counts[0]
            image = DepthMap._load_grid_image(photo, grid.shape, dev).cpu().numpy()
            py_out = os.path.join(OUT_DIR, "mesh_colors_python.obj")
            t0 = time.perf_counter()
            writers.write_obj(py_out, mesh, grid, src.original_size, mode.value, image,
                              use_native=False)
            with open(out, "rb") as a, open(py_out, "rb") as b:
                same = a.read() == b.read()
            print(f"[8] the native OBJ equals the Python writer's bytes: {same} (Python writer "
                  f"{time.perf_counter() - t0:.1f} s)")
            require(same, "the native OBJ differs from the Python writer's")
            os.remove(py_out)
            require(bool(np.isfinite(grid).all()), "non-finite depth grid")
    return colors_counts


@contextlib.contextmanager
def answered_with(params):
    """The loader of the CLI and of ``MatrixEyes`` answered with ``params``,
    the phase-4 weights (bf16 on the card): the repository holds no trained
    checkpoint."""
    import torch

    from matrix_eyes_tpu_torch import api
    from matrix_eyes_tpu_torch.config import DEPTH_PRO
    from matrix_eyes_tpu_torch.pt import loader

    def phase4_weights(path, dtype, device, convert_checkpoints=False, parts=loader.PARTS,
                       cfg=None, quantize_int8=False, mixed_bf16=False):
        require(dtype == torch.bfloat16 and torch.device(device).type == "cuda"
                and not quantize_int8 and not mixed_bf16 and not convert_checkpoints,
                f"checkpoint asked for {dtype} on {device} (int8 {quantize_int8}, mixed "
                f"{mixed_bf16}, convert {convert_checkpoints})")
        return DEPTH_PRO, {part: params[part] for part in parts}

    real_load = loader.load_checkpoint
    loader.load_checkpoint = api.load_checkpoint = phase4_weights
    try:
        yield
    finally:
        loader.load_checkpoint = api.load_checkpoint = real_load


def phase_batch(dev, params, photos: list) -> dict:
    """The batched path through the CLI and the library session, the CLI's
    checkpoint reader answered with the phase-4 weights; returns the batch-4
    directory run's launch counts."""
    with answered_with(params):
        return _batch_runs(dev, params, photos)


def _batch_runs(dev, params, photos: list) -> dict:
    import numpy as np
    import torch
    from PIL import Image

    from matrix_eyes_tpu_torch import api, cli, pipeline
    from matrix_eyes_tpu_torch.config import DEPTH_PRO
    from matrix_eyes_tpu_torch.io.image import load_source_image
    from matrix_eyes_tpu_torch.models import depth_pro

    cfg = DEPTH_PRO
    in_dir = os.path.dirname(photos[0])
    outs = {}
    for bs in (4, 1):
        outs[bs] = os.path.join(OUT_DIR, f"batch{bs}")
        shutil.rmtree(outs[bs], ignore_errors=True)
        os.makedirs(outs[bs])

    def run_dir(bs):
        argv = ([f"--batch-size={bs}"] if bs > 1 else []) + [in_dir, outs[bs]]
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        require(rc == 0, f"cli.main({argv}) exited {rc}")
        return time.perf_counter() - t0

    # has_f of every mixed-focal forward of the batch-4 run, read where the
    # focal lengths are still on the host (the forward is a CUDA graph)
    mixed = []
    real_batch = pipeline.forward_batch

    def forward_batch(cfg_, params_, img, f_norms, mesh=None):
        if any(f is None for f in f_norms):
            mixed.append([f is not None for f in f_norms])
        return real_batch(cfg_, params_, img, f_norms, mesh)

    pipeline.forward_batch = forward_batch
    t0 = time.perf_counter()
    try:
        _, counts, shapes = counted_run(lambda: run_dir(4))
    finally:
        pipeline.forward_batch = real_batch
    first = time.perf_counter() - t0
    expect = {"attention_qkv": 2 * 3 * cfg.depth, "conv3x3": 48, "linker_scan": 0,
              "attention_flash": 0, "threefry": 0}
    print(f"[9] cli --batch-size=4 over {len(photos)} photos: first run {first:.3f} s; "
          f"launches {counts}; conv3x3 batch sizes {sorted({k[0] for k in shapes})}")
    require(counts == expect, f"batch-4 launch counts {counts}, expected {expect}")
    print(f"[9] mixed-focal forwards, has_f: {mixed}")
    require(mixed == [[False, False, True, False], [False] * 4],
            f"the mixed forward saw has_f {mixed}")
    require({k[0] for k in shapes} == {4}, f"conv3x3 ran at batch sizes {shapes}")
    for p in photos:
        out = os.path.join(outs[4], os.path.splitext(os.path.basename(p))[0] + ".png")
        with Image.open(p) as im:
            want = im.size
        require(_png_size(out) == want, f"{out} is {_png_size(out)}, its source {want}")
    print(f"[9] every PNG decodes to its source size: "
          f"{[_png_size(os.path.join(outs[4], n)) for n in sorted(os.listdir(outs[4]))]}")

    # the library session at the CLI's chunk shapes: the first four photos,
    # and the fifth padded to four with copies of itself (as the CLI pads
    # it), each photo against the one-photo forward of MatrixEyes.depth_map
    # (inverse_depth before the DepthMap's clamp, which would hide all but
    # [0.004, 10] of the random weights' [1e-4, 1e4])
    me = api.MatrixEyes("phase-4 weights")
    batch = list(me.inverse_depth_batch(photos[:4])) + [
        me.inverse_depth_batch(photos[4:] * 4)[0]]
    for p, got in zip(photos, batch):
        src = load_source_image(p)
        img = pipeline.preprocess_image(src.rgb, cfg.img_size, me.runtime.resolved_dtype(), dev)
        f_norm = src.f_norm()
        one = (depth_pro.forward_with_fnorm(cfg, params, img, f_norm) if f_norm is not None
               else depth_pro.forward_with_fov(cfg, params, img)[0])[0].cpu().numpy()
        err = float(np.abs(got - one).max())
        ref = float(np.abs(one).max())
        print(f"[9] {os.path.basename(p)}: inverse_depth_batch at its chunk's shape vs its "
              f"one-photo forward max_abs={err:.3e} max_ref={ref:.3e} ({err / ref:.2e} of max "
              f"ref)")
        require(np.isfinite(got).all() and err <= BF16_REL * ref,
                f"{p}: the batch's inverse depth leaves the bf16 gate of its one-photo forward")
    # the CLI's files at --batch-size=4 against --batch-size=1: a photo in
    # another's slot differs by tens of counts on average, bf16 rounding by
    # a fraction of one (a few grid pixels of the random weights flip across
    # the clamp, so the largest difference says little)
    run_dir(1)
    for p in photos:
        name = os.path.splitext(os.path.basename(p))[0] + ".png"
        mean, p999, top = png_diff(os.path.join(outs[4], name), os.path.join(outs[1], name))
        print(f"[9] {name}: --batch-size=4 vs 1 PNG pixels mean |diff| {mean:.4f} "
              f"counts, 99.9th percentile {p999:.0f}, max {top}")
        require(mean <= PNG_MEAN_COUNTS,
                f"{name}: the batch-4 PNG leaves the gate of the batch-1 PNG (mean |diff| <= "
                f"{PNG_MEAN_COUNTS} counts)")
    walls = {4: [], 1: []}
    for bs in (4, 1, 1, 4):
        walls[bs].append(run_dir(bs))
    rates = {bs: [len(photos) / w for w in ws] for bs, ws in walls.items()}
    print(f"[9] warm directory of {len(photos)} photos, photos/s: --batch-size=4 "
          f"{', '.join(f'{r:.3f}' for r in rates[4])}; --batch-size=1 "
          f"{', '.join(f'{r:.3f}' for r in rates[1])} (walls s {walls})")
    return counts


# per policy: (the ViT's attention dtype, conv3x3's dtype)
POLICY_DTYPES = {"f16": ("float16", "float16"), "mixed": ("bfloat16", "float32"),
                 "int8": ("bfloat16", "bfloat16")}


def _tree_bytes(tree) -> int:
    from matrix_eyes_tpu_torch.models.spec import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def rel_gap(a, ref) -> float:
    """max |a - ref| over max |ref|"""
    return ((a.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def phase_policy(dev, policy: str, phase: int, canonical: dict, src, photo: str, ref_inv,
                 bf16_gap: float, conv_rows: dict) -> tuple:
    """``cli.main([f"--dtype={policy}", photo, out])`` twice at full
    DEPTH_PRO width, the checkpoint reader answered with the canonical f32
    tree of phase 4's seed, so that the loader's policy conversion runs.
    Returns the first run's counts and the per-forward conv3x3 sums."""
    import torch

    from matrix_eyes_tpu_torch import cli, pipeline
    from matrix_eyes_tpu_torch.config import DEPTH_PRO, RuntimeConfig, parse_dtype_policy
    from matrix_eyes_tpu_torch.models import depth_pro
    from matrix_eyes_tpu_torch.pt import convert, loader

    cfg = DEPTH_PRO
    vit_dtype, conv_name = POLICY_DTYPES[policy]
    conv_dtype = getattr(torch, conv_name)
    out = os.path.join(OUT_DIR, f"chip_smoke_{policy}.png")
    loaded = {}
    real_read, real_load = convert.read_checkpoint, loader.load_checkpoint

    def read(path, parts=convert.PARTS, cfg=None):
        return DEPTH_PRO, {part: canonical[part] for part in parts}

    def load(*args, **kwargs):
        loaded["cfg"], loaded["params"] = real_load(*args, **kwargs)
        return loaded["cfg"], loaded["params"]

    convert.read_checkpoint, loader.load_checkpoint = read, load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    walls, counts, by_dtype, shapes = [], [], [], []
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            rc, c, sh = counted_run(lambda: cli.main([f"--dtype={policy}", photo, out]))
            walls.append(time.perf_counter() - t0)
            require(rc == 0, f"cli.main --dtype={policy} exited {rc}")
            counts.append(c)
            by_dtype.append(launches_by("attention_qkv", 4))
            shapes.append(sh)
    finally:
        convert.read_checkpoint, loader.load_checkpoint = real_read, real_load
    peak = torch.cuda.max_memory_allocated()
    print(f"[{phase}] cli --dtype={policy} wall s: first {walls[0]:.3f} (the policy's "
          f"conversion included), second {walls[1]:.3f}; launches per run: {counts}; "
          f"attention_qkv by dtype: {by_dtype}")
    expect = {"attention_qkv": 3 * cfg.depth, "conv3x3": 24, "linker_scan": 0,
              "attention_flash": 0, "threefry": 0}
    want_dtypes = {vit_dtype: 2 * cfg.depth, "float32": cfg.depth}
    require(all(c == expect for c in counts), f"--dtype={policy}: launch counts {counts}, "
            f"expected {expect} per run")
    require(all(d == want_dtypes for d in by_dtype),
            f"--dtype={policy}: attention_qkv by dtype {by_dtype}, expected {want_dtypes}")
    require(shapes[0] == shapes[1], f"--dtype={policy}: conv3x3 shapes differ between runs")
    require(all(k[5] == conv_dtype for k in shapes[0]),
            f"--dtype={policy}: conv3x3 launches of another dtype than {conv_dtype}: "
            f"{list(shapes[0])}")
    per_forward = conv_per_forward(conv_rows, shapes[0], conv_dtype, phase)
    size = _png_size(out)
    require(size == (4032, 3024), f"--dtype={policy}: depth map PNG is {size}")
    params = loaded["params"]
    dtype, q8, mixed = parse_dtype_policy(policy)
    runtime = RuntimeConfig(dtype, device=dev, quantize_int8=q8, mixed_bf16=mixed)
    img = pipeline.preprocess_image(src.rgb, cfg.img_size, runtime.image_dtype(), dev)
    inv, fov_deg = depth_pro.forward_with_fov(cfg, params, img)
    require(bool(torch.isfinite(inv).all()) and bool(torch.isfinite(fov_deg).all()),
            f"--dtype={policy}: non-finite inverse depth or FOV")
    gap = rel_gap(inv, ref_inv)
    weights = _tree_bytes(params)
    print(f"[{phase}] --dtype={policy}: {out} {size[0]}x{size[1]}; weights {weights} bytes "
          f"({weights / 2**30:.3f} GiB); peak device memory {peak / 2**30:.2f} GiB, "
          f"{(peak - before) / 2**30:.2f} GiB above the {before / 2**30:.2f} GiB held before "
          f"the runs (the canonical f32 tree among them); fov {fov_deg.item():.4f} deg; "
          f"inverse depth gap to the --dtype f32 run (max |diff| / max |f32|) {gap:.3e}, "
          f"bf16's {bf16_gap:.3e}")
    if policy == "mixed":
        require(gap < bf16_gap, f"mixed's gap to f32 {gap:.3e} is not below bf16's "
                f"{bf16_gap:.3e}")
    loaded.clear()
    del params
    torch.cuda.empty_cache()
    return counts[0], per_forward


def phase_policies_mid(dev) -> None:
    """Each policy at MID: the card (kernels, cuBLAS int8 products) against
    the CPU (plain versions) from the same canonical f32 weights."""
    import numpy as np
    import torch

    from matrix_eyes_tpu_torch.config import MID, RuntimeConfig, parse_dtype_policy
    from matrix_eyes_tpu_torch.models import depth_pro
    from matrix_eyes_tpu_torch.models import fov as fov_mod
    from matrix_eyes_tpu_torch.models.init import init_params
    from matrix_eyes_tpu_torch.models.spec import tree_leaves, tree_map
    from matrix_eyes_tpu_torch.pt.convert import place_params

    cfg = MID
    canonical = init_params(cfg, torch.Generator().manual_seed(3), "cpu", torch.float32)
    img = np.random.RandomState(5).uniform(-1, 1, (1, cfg.img_size, cfg.img_size, 3))
    img = torch.from_numpy(img.astype(np.float32))
    for policy in ("f16", "mixed", "int8"):
        dtype, q8, mixed = parse_dtype_policy(policy)
        runtime = RuntimeConfig(dtype, device="cpu", quantize_int8=q8, mixed_bf16=mixed)
        outs = {}
        for where in ("cpu", dev):
            params = place_params(canonical, where, dtype, quantize_int8=q8, mixed_bf16=mixed)
            x = img.to(where, runtime.image_dtype())
            with torch.no_grad():
                can, lowres = depth_pro.canonical_inverse_depth(cfg, params, x)
                fov_deg = fov_mod.forward(cfg, params["fov"], x, lowres)
            outs[str(where)] = (params, can.float().cpu(), fov_deg.float().cpu())
        (cpu_p, can_c, fov_c), (gpu_p, can_g, fov_g) = outs["cpu"], outs[str(dev)]
        differ = []

        def check(path, a):
            b = _at(gpu_p, path)
            if a.dtype != b.dtype or not torch.equal(a, b.cpu()):
                differ.append(".".join(map(str, path)))

        tree_map(check, cpu_p)
        same_leaves = not differ and len(tree_leaves(cpu_p)) == len(tree_leaves(gpu_p))
        rel = POLICY_MID_REL[policy]
        can_err, fov_err = rel_gap(can_g, can_c), rel_gap(fov_g, fov_c)
        ok = (same_leaves and bool(torch.isfinite(can_g).all()) and can_err <= rel
              and fov_err <= rel)
        print(f"[13] MID --dtype={policy} card vs CPU: leaves placed on the card equal the "
              f"CPU's: {same_leaves} {differ[:6]}; canonical inverse depth "
              f"max_rel={can_err:.3e}, fov {fov_g.item():.6f} vs {fov_c.item():.6f} deg (rel "
              f"{fov_err:.3e}); gate {rel:g} {'ok' if ok else 'FAIL'}")
        require(ok, f"--dtype={policy} at MID: the card disagrees with the CPU")


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _http(url: str, body=None) -> tuple:
    """(status, content type, body bytes) of a GET, or of a POST of ``body``."""
    import urllib.request

    req = urllib.request.Request(url, data=body, method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


@contextlib.contextmanager
def serving(session, max_batch: int):
    """``serve.create_server`` over ``session`` on an ephemeral port, in a
    thread; yields its base URL and stops it after."""
    import threading

    from matrix_eyes_tpu_torch import serve

    server = serve.create_server(session, port=0, max_inflight=16, max_batch=max_batch)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        require(not thread.is_alive(), "the server thread did not stop")


def phase_serve(dev, canonical: dict, src, photos: list) -> tuple:
    """The HTTP server at full DEPTH_PRO width with the phase-4 weights and
    the phase-4 photo as a JPEG body: /healthz; at --max-batch=1 the
    depth-map PNG, the compact stereogram and the PLY equal
    ``MatrixEyes.process`` of the same file byte for byte, and /v1/depth
    ``MatrixEyes.inverse_depth`` bit for bit; at --max-batch=4, 8 concurrent
    /v1/depth requests over four photos against their one-photo forwards
    (with a focal length, and with the FOV head), at least one forward at
    batch 4; then
    scripts/torch_serve_burst.py. Returns the launch counts of the depth-map
    request and of the batched requests."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from PIL import Image

    from matrix_eyes_tpu_torch import api
    from matrix_eyes_tpu_torch.pt.convert import place_params

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_serve_burst

    params = place_params(canonical, dev, torch.bfloat16)  # phase 4's weights
    photo = os.path.join(OUT_DIR, "serve_photo.jpg")
    Image.fromarray(src.rgb).save(photo, quality=95)
    with open(photo, "rb") as f:
        body = f.read()
    with answered_with(params):
        me = api.MatrixEyes("phase-4 weights")
    expect = {"attention_qkv": 72, "conv3x3": 24, "linker_scan": 0, "attention_flash": 0,
              "threefry": 0}
    with serving(me, 1) as url:
        code, ctype, health = _http(url + "/healthz")
        health = json.loads(health)
        print(f"[14] /healthz: {health}")
        require(code == 200 and ctype == "application/json" and set(health) == {
            "status", "model", "img_size", "dtype", "weight_policy", "default_dtype_policy"}
            and (health["img_size"], health["dtype"], health["weight_policy"]) == (
                1536, "bfloat16", "plain"), f"/healthz answered {code} {health}")
        serve_counts = None
        for fmt, fname, image_format in (("depthmap", "serve_lib.png", "depthmap"),
                                         ("stereogram", "serve_lib_stereo.png", "stereogram"),
                                         ("ply", "serve_lib.ply", "depthmap")):
            t0 = time.perf_counter()
            (code, ctype, got), counts, _ = counted_run(
                lambda: _http(url + f"/v1/process?format={fmt}", body))
            wall = time.perf_counter() - t0
            lib = os.path.join(OUT_DIR, fname)
            me.process(photo, lib, image_format=image_format)
            with open(lib, "rb") as f:
                same = f.read() == got
            print(f"[14] /v1/process?format={fmt}: {code} {ctype}, {len(got)} bytes in "
                  f"{wall:.3f} s; launches {counts}; equals MatrixEyes.process: {same}")
            # the compact stereogram draws its noise on the card: one threefry launch
            want = dict(expect, threefry=int(fmt == "stereogram"))
            require(code == 200 and counts == want, f"{fmt}: {code}, launches {counts}")
            require(same, f"the served {fmt} differs from MatrixEyes.process of the same file")
            if fmt == "depthmap":
                serve_counts = counts
                require(_png_size(lib) == (4032, 3024), f"the depth map is {_png_size(lib)}")
        code, ctype, got = _http(url + "/v1/depth", body)
        inv = np.load(io.BytesIO(got))
        ref = me.inverse_depth(photo)
        print(f"[14] /v1/depth: {code} {ctype} {inv.shape} {inv.dtype}; equals "
              f"MatrixEyes.inverse_depth bit for bit: {np.array_equal(inv, ref)}")
        require(code == 200 and np.array_equal(inv, ref),
                "/v1/depth differs from MatrixEyes.inverse_depth")

    # four photos, eight concurrent requests, against one-photo forwards:
    # with a focal length the bf16 gate holds pixel for pixel; with the FOV
    # head, whose tiny angle scales the random weights' inverse depth
    # ~1700x, pixels whose canonical depth sits near zero can flip across
    # the DepthMap's clamp [0.004, 10] under the batch's bf16 rounding (as
    # in phase 9), so those responses are held to being nearest their own
    # photo's answer
    bodies = []
    for p in photos[:4]:
        with open(p, "rb") as f:
            bodies.append(f.read())
    batch_counts = None
    for query, focal in (("?focal-length=35", 35.0), ("", None)):
        refs = [me.inverse_depth(p, focal_length_35mm=focal) for p in photos[:4]]
        with serving(me, 4) as url:
            with ThreadPoolExecutor(max_workers=8) as pool:
                t0 = time.perf_counter()
                results, counts, _ = counted_run(lambda: list(pool.map(
                    lambda i: _http(url + "/v1/depth" + query, bodies[i % 4]), range(8))))
                wall = time.perf_counter() - t0
            by_batch = launches_by("attention_qkv", 0)
        batch_counts = batch_counts or counts
        print(f"[14] --max-batch=4, /v1/depth{query or ' (FOV head)'}: 8 concurrent requests "
              f"over 4 photos in {wall:.3f} s; launches {counts}; attention_qkv launches by "
              f"batch {by_batch}")
        ok = True
        for i, (code, _ctype, got) in enumerate(results):
            got, ref = np.load(io.BytesIO(got)), refs[i % 4]
            err, scale = np.abs(got - ref), float(np.abs(ref).max())
            nearest = int(np.argmin([np.abs(got - r).mean() for r in refs]))
            beyond = int((err > BF16_REL * scale).sum())
            print(f"[14] request {i} ({os.path.basename(photos[i % 4])}): max_abs="
                  f"{err.max():.3e} ({err.max() / scale:.2e} of max ref), mean_abs="
                  f"{err.mean():.3e}, pixels beyond 2e-2 of max ref {beyond} of {err.size}; "
                  f"nearest reference: photo {nearest}")
            ok = ok and code == 200 and bool(np.isfinite(got).all()) and nearest == i % 4
            if focal is not None:
                ok = ok and float(err.max()) <= BF16_REL * scale
        require(ok, f"/v1/depth{query}: a batched response left its gate")
        require(by_batch.get(4 * 35, 0) > 0, f"no forward ran at batch 4: {by_batch}")

    report = torch_serve_burst.main([
        "--photo", photo, "--max-batch", "4", "--requests", "16", "--concurrency", "8",
        "--compare-output-streams", "--out", os.path.join(OUT_DIR, "serve_burst.json")],
        session=me)
    for stream, runs in (("default", report), ("own", report["own_output_stream"])):
        for mode in ("batched", "serialized"):
            r = runs[mode]
            print(f"[14] burst, outputs on the {stream} stream, --max-batch={r['max_batch']}: "
                  f"{r['requests_per_s']:.3f} requests/s ({r['requests']} at concurrency "
                  f"{r['concurrency']}, {r['wall_s']:.3f} s); latency p50 "
                  f"{r['latency_s']['p50']:.3f} s, p95 {r['latency_s']['p95']:.3f} s, max "
                  f"{r['latency_s']['max']:.3f} s; idle request "
                  f"{r['idle_latency_s']['median']:.3f} s (runs "
                  f"{[round(x, 3) for x in r['idle_latency_s']['runs']]}); forwards' batch "
                  f"sizes {r['batch_sizes']}")
        print(f"[14] burst, outputs on the {stream} stream: --max-batch=4 / 1 = "
              f"{runs['coalescing_speedup']:.3f}")
    del me, params
    torch.cuda.empty_cache()
    return serve_counts, batch_counts


def _warm_start_policy(cfg, canonical: dict, policy: str, pt: str, photo: str) -> dict:
    """``cli.main`` cold with --convert-checkpoints, then warm with the reader
    made to raise, under ``policy``; the warm run's leaves on the card
    against the CPU's placement of the same canonical tree (its f16
    convention; exact for mixed). Returns the warm run's launch counts."""
    import torch

    from matrix_eyes_tpu_torch import cli
    from matrix_eyes_tpu_torch.config import parse_dtype_policy
    from matrix_eyes_tpu_torch.models.spec import tree_leaves, tree_map
    from matrix_eyes_tpu_torch.pt import convert, loader

    reads, loaded = [], {}

    def read(path, parts=convert.PARTS, cfg_=None):
        reads.append(tuple(parts))
        return cfg, {part: canonical[part] for part in parts}

    def refuse(*_a, **_k):
        raise RuntimeError("the warm start read the .pt")

    real_read, real_load = convert.read_checkpoint, loader.load_checkpoint

    def load(*a, **k):
        result = real_load(*a, **k)
        loaded["params"] = result[1]
        return result

    flags = [f"--checkpoint-path={pt}"] + ([f"--dtype={policy}"] if policy != "bf16" else [])
    walls = {}
    loader.load_checkpoint = load
    try:
        for run, reader in (("cold", read), ("warm", refuse)):
            convert.read_checkpoint = reader
            out = os.path.join(OUT_DIR, f"warm_start_{policy}_{run}.png")
            argv = (["--convert-checkpoints"] if run == "cold" else []) + flags + [photo, out]
            t0 = time.perf_counter()
            rc, counts, _ = counted_run(lambda: cli.main(argv))
            walls[run] = time.perf_counter() - t0
            require(rc == 0, f"cli.main({argv}) exited {rc}")
            require(_png_size(out) == _png_size(photo), f"{out} is {_png_size(out)}")
    finally:
        convert.read_checkpoint, loader.load_checkpoint = real_read, real_load
    d = os.path.dirname(pt)
    files = sorted(n for n in os.listdir(d) if ".torch." in n or "-torch-" in n)
    nbytes = sum(os.path.getsize(os.path.join(d, n)) for n in files)
    dtype, q8, mixed = parse_dtype_policy(policy)
    host = tree_map(lambda _p, t: t.cpu() if mixed else t.cpu().to(torch.float16), canonical)
    want = convert.place_params(host, "cpu", dtype, quantize_int8=q8, mixed_bf16=mixed)
    got = loaded.pop("params")
    differ = []

    def check(path, w):
        g = _at(got, path)
        if w.dtype != g.dtype or not torch.equal(w, g.cpu()):
            differ.append(".".join(map(str, path)))

    tree_map(check, want)
    same = not differ and len(tree_leaves(want)) == len(tree_leaves(got))
    print(f"[15] --dtype={policy} at {'DEPTH_PRO' if cfg.depth == 24 else 'MID'}: cold "
          f"(--convert-checkpoints) {walls['cold']:.3f} s, warm {walls['warm']:.3f} s from "
          f"cli.main to the PNG; the cold run read the .pt {len(reads)} time(s), the warm run "
          f"none; launches of the warm run {counts}; cache files {files}, {nbytes} bytes "
          f"({nbytes / 2**30:.3f} GiB); the warm leaves on the card equal the CPU's "
          f"placement: {same} {differ[:6]}")
    require(same, f"--dtype={policy}: the warm leaves differ from the CPU's placement")
    return counts


def phase_warm_start(dev, canonical: dict, photo: str) -> dict:
    """Warm start from the port's weight caches (``pt/loader.py``): a
    stand-in .pt gives the stamp and the reader returns the canonical
    weights; bf16 at full width, then int8 and mixed (full width when the
    disk holds their caches, else MID); a ``compare_dumps`` table of the
    card against the CPU at MID, f32. Deletes the caches at the end; returns
    the warm bf16 run's launch counts."""
    import numpy as np
    import torch

    from matrix_eyes_tpu_torch import debug
    from matrix_eyes_tpu_torch.config import DEPTH_PRO, MID
    from matrix_eyes_tpu_torch.models.init import init_params
    from matrix_eyes_tpu_torch.models.spec import tree_map

    d = os.path.join(OUT_DIR, "weight_caches")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    pt = os.path.join(d, "depth_pro.pt")
    with open(pt, "wb") as f:  # the stamp; the reader returns the weights
        f.write(b"stand-in for depth_pro.pt\n")
    try:
        counts = _warm_start_policy(DEPTH_PRO, canonical, "bf16", pt, photo)
        free = shutil.disk_usage(d).free
        full = free > 16 * 2**30  # ~1 GiB of int8 and ~2.4 GiB of mixed caches, and copies
        print(f"[15] {free / 2**30:.1f} GiB free on the disk: int8 and mixed at "
              f"{'full width' if full else 'MID'}")
        cfg, tree, pt2 = DEPTH_PRO, canonical, pt
        if not full:
            cfg = MID
            tree = init_params(MID, torch.Generator(device=dev).manual_seed(0), dev)
            pt2 = os.path.join(d, "mid.pt")
            with open(pt2, "wb") as f:
                f.write(b"stand-in for a MID checkpoint\n")
        for policy in ("int8", "mixed"):
            _warm_start_policy(cfg, tree, policy, pt2, photo)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()

    cpu_params = init_params(MID, torch.Generator().manual_seed(3), "cpu", torch.float32)
    gpu_params = tree_map(lambda _p, t: t.to(dev), cpu_params)
    img = np.random.RandomState(5).uniform(-1, 1, (1, MID.img_size, MID.img_size, 3))
    img = torch.from_numpy(img.astype(np.float32))
    report = debug.compare_dumps(debug.dump_stages(MID, gpu_params, img.to(dev)),
                                 debug.dump_stages(MID, cpu_params, img))
    for stage, rel in report.items():
        print(f"[15] compare_dumps, MID f32, card vs CPU: {stage:24s} {rel:.3e}")
    require(len(report) == 12 and all(math.isfinite(v) for v in report.values()),
            f"compare_dumps: stages missing or not finite: {report}")
    return counts


def _mesh_expectations(cfg, data: int, model: int) -> dict:
    """attention_qkv's launches by shape on each rank of a (data, model)
    mesh at one photo: the patch ViT on ceil(35 / data) patches, the image
    and FOV ViTs on the one image, each with num_heads / model heads."""
    import torch

    from matrix_eyes_tpu_torch.ops.flash_attention import kv_path

    h = cfg.num_heads // model
    n, d = cfg.seq_len, cfg.head_dim
    bf, f32 = kv_path(n, d, torch.bfloat16), kv_path(n, d, torch.float32)
    return {str((-(-35 // data), n, h, d, "bfloat16", bf)): cfg.depth,
            str((1, n, h, d, "bfloat16", bf)): cfg.depth,
            str((1, n, h, d, "float32", f32)): cfg.depth}


def _rank_summary(phase_tag: str, r: dict) -> str:
    calls = {k: (v["calls"], v["bytes"]) for k, v in r["report"]["collectives"].items()}
    return (f"{phase_tag} rank {r['rank']} mesh {r['mesh'][0]}x{r['mesh'][1]} on {r['device']}: "
            f"launches attention_qkv {r['kernels']['attention_qkv']} conv3x3 "
            f"{r['kernels']['conv3x3']}; attention by (B, N, H, D, dtype, path) "
            f"{r['kernels']['attention_by_shape']}; conv3x3 by N {r['kernels']['conv3x3_by_batch']}"
            f"; collectives (calls, bytes) {calls}; patch rows {r['report']['patch_rows_per_rank']}"
            f"; shard {r['shard_s']:.2f} s; forward walls s {[round(w, 3) for w in r['walls']]}")


def _entry_points_2x2(dev, cfg, weights: str, photos: list, ref_inv) -> dict:
    """What a user calls under ``--devices=2x2``, on four gloo ranks sharing
    the card, at full width with the phase-4 weights (the ranks' checkpoint
    reader answers with them): one rank of the CLI on the phase-4 photo
    (the FOV head), on the EXIF photo with ``--focal-length=28`` (no FOV
    head) and on a directory of three photos at ``--batch-size=2`` (the
    batch split over data); a ``MatrixEyes`` session's
    ``inverse_depth_batch`` and ``process_batch`` on the mesh. Rank 0's
    PNGs are held to phase 4's and phase 9's one-card PNGs, the session's
    inverse depth to phase 4's; every call's launches and collectives to
    what its forwards run. Returns rank 0's launches by call and every
    rank's modes of the forwards by call (gloo: eager on every call)."""
    import torch

    from matrix_eyes_tpu_torch.parallel import launch
    from matrix_eyes_tpu_torch.parallel.checks import run_entry_points

    out = os.path.join(OUT_DIR, "mesh_2x2")
    shutil.rmtree(out, ignore_errors=True)
    in_dir = os.path.join(out, "photos")
    os.makedirs(in_dir)
    trio = [photos[1], photos[2], photos[4]]  # the first pair's forward is the mixed one
    for p in trio:
        shutil.copy(p, in_dir)
    one = os.path.join(OUT_DIR, "batch1")  # phase 9's one-card PNGs

    def ref(p):
        return os.path.join(one, os.path.splitext(os.path.basename(p))[0] + ".png")

    ckpt = [f"--checkpoint-path={weights}"]
    calls = [  # (name, call, [(rank 0's PNG, its one-card PNGs)])
        ("cli", dict(cli=ckpt + [photos[0], os.path.join(out, "photo.png")], batch=1,
                     n_vits=3, forwards=1),
         [(os.path.join(out, "photo.png"),
           [os.path.join(OUT_DIR, "chip_smoke_depthmap.png"), ref(photos[0])])]),
        ("cli_focal", dict(cli=ckpt + ["--focal-length=28", photos[2],
                                       os.path.join(out, "focal.png")],
                           batch=1, n_vits=2, forwards=1),
         [(os.path.join(out, "focal.png"), [ref(photos[2])])]),
        ("cli_batch2", dict(cli=ckpt + ["--batch-size=2", in_dir, out], batch=2, n_vits=3,
                            forwards=2),
         [(os.path.join(out, os.path.basename(ref(p))), [ref(p)]) for p in trio]),
        ("session_inverse_depth", dict(inverse_depth_batch=[photos[0]], batch=1, n_vits=3,
                                       forwards=1), []),
        ("session_process_batch", dict(process_batch=[(photos[3],
                                                       os.path.join(out, "session.png"))],
                                       batch_size=1, batch=1, n_vits=3, forwards=1),
         [(os.path.join(out, "session.png"), [ref(photos[3])])]),
    ]
    t0 = time.perf_counter()
    ranks = launch(run_entry_points, (2, 2), cfg, weights, [c for _n, c, _p in calls],
                   backend="gloo", devices=[str(dev)] * 4, timeout=MESH_TIMEOUT)
    print(f"[16] entry points on a 2x2 gloo world sharing {dev}: "
          f"{time.perf_counter() - t0:.1f} s with start-up")
    counts, modes = {}, {}
    for i, (name, call, pngs) in enumerate(calls):
        got = [r["calls"][i] for r in ranks]
        modes[name] = [g["modes"] for g in got]
        for r, g in zip(ranks, got):
            require(not r["foreign_modules"], f"a rank loaded jax: {r['foreign_modules']}")
            want = {"attention_qkv": call["forwards"] * call["n_vits"] * cfg.depth,
                    "conv3x3": call["forwards"] * 24}
            have = {k: g["kernels"][k] for k in want}
            calls_ = {k: (v["calls"], v["bytes"]) for k, v in g["report"]["collectives"].items()}
            print(f"[16] {name} rank {r['rank']}: exit {g.get('rc', '-')}, wall "
                  f"{g['wall']:.2f} s (loads included, ranks time-sharing one card); launches "
                  f"{have}; attention by (B, N, H, D, dtype) "
                  f"{g['kernels']['attention_by_shape']}; conv3x3 by N "
                  f"{g['kernels']['conv3x3_by_batch']}; collectives (calls, bytes) {calls_}; "
                  f"forward modes {g['modes']}")
            require(g.get("rc", 0) == 0, f"{name}: rank {r['rank']} exited {g.get('rc')}")
            require(have == want, f"{name} rank {r['rank']}: launches {have}, expected {want}")
        counts[f"mesh_2x2_{name}"] = got[0]["kernels"]
        for png, refs in pngs:
            require(os.path.exists(png), f"{name}: rank 0 wrote no {png}")
            for r_png in refs:
                mean, p999, top = png_diff(png, r_png)
                print(f"[16] {name}: {os.path.basename(png)} vs one card's "
                      f"{os.path.relpath(r_png, OUT_DIR)}: mean |diff| {mean:.4f} counts, "
                      f"99.9th percentile {p999:.0f}, max {top}")
                require(mean <= PNG_MEAN_COUNTS, f"{name}: {png} leaves the gate of {r_png} "
                        f"(mean |diff| <= {PNG_MEAN_COUNTS} counts)")
        if "inverse_depth_batch" in call:
            res = compare(got[0]["inv"], ref_inv.cpu(), torch.bfloat16)
            same = all(torch.equal(g["inv"], got[0]["inv"]) for g in got)
            print(f"[16] {name}: inverse depth vs phase 4 max_abs={res['max_abs_err']:.3e} "
                  f"max_rel={res['max_rel_err']:.3e} (gate {BF16_REL:g}); ranks bit-equal: "
                  f"{same}")
            require(res["ok"] and same, f"{name}: the session's inverse depth")
    for c in counts.values():
        c.setdefault("linker_scan", 0)
        c.setdefault("threefry", 0)
    return counts, modes


def write_weights(dev) -> str:
    """The phase-4 weights (the seed regenerates them), written to build/
    for the ranks of phases 16 and 18, which map them from disk and each
    move only their cut to the card. Returns the path."""
    import torch

    from matrix_eyes_tpu_torch.config import DEPTH_PRO
    from matrix_eyes_tpu_torch.models.init import init_params
    from matrix_eyes_tpu_torch.models.spec import tree_map

    t0 = time.perf_counter()
    params = init_params(DEPTH_PRO, torch.Generator(device=dev).manual_seed(0), dev,
                         torch.bfloat16)
    weights = os.path.join(OUT_DIR, "weights_bf16.pt")
    torch.save(tree_map(lambda _p, t: t.cpu(), params), weights)
    del params
    torch.cuda.empty_cache()
    print(f"[16] phase-4 weights written for the ranks in {time.perf_counter() - t0:.1f} s "
          f"({os.path.getsize(weights) / 2**30:.2f} GiB)")
    return weights


def phase_multi_device(dev, src, ref_inv, photos: list, weights: str) -> tuple:
    """``--devices`` and the sharded forward on one card: the refusal of a
    mesh larger than the machine, an NCCL world of one rank bit for bit
    against phase 4, gloo ranks sharing the card at full width (1x2, 2x1,
    2x2) within the bf16 gate of phase 4, MID 2x2 on the card against the
    same mesh on the CPU under f32, int8 and mixed, and the entry points
    (the CLI's ranks, a session) at 2x2 (``_entry_points_2x2``). Returns
    rank 0's launch counts by mesh and call, and the modes the entry
    points' forwards ran in on each rank ({call: [modes of rank r]})."""
    import contextlib
    import io

    import numpy as np
    import torch

    from matrix_eyes_tpu_torch import cli, pipeline
    from matrix_eyes_tpu_torch.config import DEPTH_PRO, MID, parse_dtype_policy
    from matrix_eyes_tpu_torch.models.init import init_params
    from matrix_eyes_tpu_torch.parallel import launch
    from matrix_eyes_tpu_torch.parallel.checks import run_cases
    from matrix_eyes_tpu_torch.pt.convert import place_params

    cfg = DEPTH_PRO
    # 1. more devices than the machine has: the Device error, exit 1
    n_cards = torch.cuda.device_count()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([f"--devices={n_cards + 1}", photos[0],
                       os.path.join(OUT_DIR, "never.png")])
    want = (f"Device error: --devices={n_cards + 1}x1 needs {n_cards + 1} devices but only "
            f"{n_cards} are available")
    print(f"[16] cli.main --devices={n_cards + 1} on {n_cards} card(s): exit {rc}, "
          f"{out.getvalue().strip().splitlines()[-1]!r}")
    require(rc == 1 and want in out.getvalue(), "--devices beyond the cards was not refused")

    # the phase-4 photo's preprocessed image
    img = pipeline.preprocess_image(src.rgb, cfg.img_size, torch.bfloat16, dev).cpu()
    counts = {}
    # 2. NCCL, one rank: the real backend and launcher, bit for bit
    t0 = time.perf_counter()
    (r,) = launch(run_cases, (1, 1), [dict(cfg=cfg, params=weights, img=img)],
                  timeout=MESH_TIMEOUT)
    case = r["cases"][0]
    equal = torch.equal(case["inv"], ref_inv.cpu())
    res = compare(case["inv"], ref_inv.cpu(), torch.bfloat16)
    print(f"[16] NCCL 1x1 ({time.perf_counter() - t0:.1f} s with start-up): world "
          f"all-reduce {r['world_sum']}, inverse depth == phase 4's: {equal} "
          f"(max_abs={res['max_abs_err']:.3e}, max_rel={res['max_rel_err']:.3e}); fov "
          f"{case['fov'].item():.6f} deg; foreign modules {r['foreign_modules']}")
    print(_rank_summary("[16]", case))
    require(r["backend"] == "nccl" and r["world_sum"] == 1.0, "the NCCL world did not run")
    require(equal, "NCCL 1x1 inverse depth differs from phase 4's one-device forward")
    require(not r["foreign_modules"], f"a rank loaded jax: {r['foreign_modules']}")
    counts["mesh_nccl_1x1"] = case["kernels"]

    # 3. gloo ranks sharing the card, full width: 1x2 and 2x1 in one
    # world of two ranks, then 2x2 in a world of four with MID beside it
    mid = init_params(MID, torch.Generator().manual_seed(3), "cpu", torch.float32)
    mid_img = np.random.RandomState(5).uniform(-1, 1, (1, MID.img_size, MID.img_size, 3))
    mid_img = torch.from_numpy(mid_img.astype(np.float32))
    mid_cases = []
    for policy in ("f32", "int8", "mixed"):
        dtype, q8, mixed = parse_dtype_policy(policy)
        placed = place_params(mid, "cpu", dtype, quantize_int8=q8, mixed_bf16=mixed)
        x = mid_img.to(torch.float32 if policy in ("f32", "mixed") else torch.bfloat16)
        for where in (None, "cpu"):  # the ranks' card, then the host
            mid_cases.append((policy, where, dict(cfg=MID, params=placed, img=x,
                                                  device=where)))
    worlds = (((1, 2), [dict(cfg=cfg, params=weights, img=img, runs=2),
                        dict(cfg=cfg, params=weights, img=img, runs=2, model=1)]),
              ((2, 2), [dict(cfg=cfg, params=weights, img=img, runs=2)]
               + [c for _p, _w, c in mid_cases]))
    for shape, cases in worlds:
        n = shape[0] * shape[1]
        t0 = time.perf_counter()
        results = launch(run_cases, shape, cases, backend="gloo",
                         devices=[str(dev)] * n, timeout=MESH_TIMEOUT)
        print(f"[16] gloo world of {n} ranks sharing {dev}: "
              f"{time.perf_counter() - t0:.1f} s with start-up")
        for r in results:
            require(not r["foreign_modules"], f"a rank loaded jax: {r['foreign_modules']}")
        for i in range(2 if shape == (1, 2) else 1):
            rank_cases = [r["cases"][i] for r in results]
            data, model = rank_cases[0]["mesh"]
            for rc_ in rank_cases:
                print(_rank_summary("[16]", rc_))
                want = _mesh_expectations(cfg, data, model)
                require(rc_["kernels"]["attention_qkv"] == 3 * cfg.depth
                        and rc_["kernels"]["conv3x3"] == 24,
                        f"{data}x{model} rank {rc_['rank']}: launches {rc_['kernels']}")
                require(rc_["kernels"]["attention_by_shape"] == want,
                        f"{data}x{model}: attention shapes "
                        f"{rc_['kernels']['attention_by_shape']}, expected {want}")
                reduces = rc_["report"]["collectives"].get("all-reduce", {}).get("calls", 0)
                require(reduces == (6 * cfg.depth if model > 1 else 0),
                        f"{data}x{model}: {reduces} all-reduces")
            res = compare(rank_cases[0]["inv"], ref_inv.cpu(), torch.bfloat16)
            same = all(torch.equal(c["inv"], rank_cases[0]["inv"]) for c in rank_cases)
            walls = [c["walls"][-1] for c in rank_cases]
            print(f"[16] {data}x{model} bf16 DEPTH_PRO, {n} ranks time-sharing one card "
                  f"(not a speed-up): inverse depth vs phase 4 max_abs="
                  f"{res['max_abs_err']:.3e} max_rel={res['max_rel_err']:.3e} "
                  f"(gate {BF16_REL:g}) {'ok' if res['ok'] else 'FAIL'}; ranks bit-equal: "
                  f"{same}; warm forward wall per rank s {[round(w, 3) for w in walls]}")
            require(res["ok"], f"{data}x{model}: inverse depth outside the bf16 gate")
            require(same, f"{data}x{model}: the ranks' inverse depths differ")
            counts[f"mesh_{data}x{model}"] = rank_cases[0]["kernels"]
    # 4. MID 2x2, card against CPU over the same ranks
    rank0 = results[0]["cases"][1:]
    for k in range(0, len(rank0), 2):
        policy = mid_cases[k][0]
        card, host = rank0[k], rank0[k + 1]
        if policy == "f32":
            f_norm = math.tan(0.5 * host["fov"].item() * math.pi / 180.0) / 0.5
            a, b = card["inv"] * f_norm, host["inv"] * f_norm
            ok = (bool(torch.isfinite(a).all())
                  and bool(((a - b).abs() <= E2E_ATOL + E2E_RTOL * b.abs()).all())
                  and bool(torch.allclose(card["fov"], host["fov"], rtol=E2E_RTOL, atol=0)))
            err = (a - b).abs().max().item()
        else:  # as phase 13: the canonical inverse depth and the FOV, each
            can = [r["inv"] * (torch.tan(0.5 * r["fov"] * math.pi / 180.0) / 0.5)
                   for r in (card, host)]
            err = rel_gap(can[0], can[1])
            fov_err = rel_gap(card["fov"], host["fov"])
            ok = (bool(torch.isfinite(can[0]).all())
                  and max(err, fov_err) <= POLICY_MID_REL[policy])
        print(f"[16] MID 2x2 --dtype={policy} card vs CPU: "
              f"{'inverse depth x f_norm max_abs' if policy == 'f32' else 'canonical max_rel'}"
              f"={err:.3e}, fov {card['fov'].item():.6f} vs {host['fov'].item():.6f} deg; "
              f"collectives {card['report']['collectives']} {'ok' if ok else 'FAIL'}")
        require(ok, f"MID 2x2 --dtype={policy}: the card disagrees with the CPU")
    # 5. the entry points a user calls, at 2x2
    entry_counts, modes = _entry_points_2x2(dev, cfg, weights, photos, ref_inv)
    counts.update(entry_counts)
    for c in counts.values():
        c.setdefault("linker_scan", 0)
        c.setdefault("threefry", 0)
    return counts, modes


def _eager_then_graphs(name: str, fn, calls: int = 3) -> tuple:
    """``fn()`` eagerly (``MATRIX_EYES_AOT=off``), then ``calls`` times through
    the graph cache (warm-up, capture, replays). Returns (the eager result,
    the last replay's result, the last replay's launch counts, the walls of
    the graph calls)."""
    import torch

    from matrix_eyes_tpu_torch import aot

    with aot.disabled():
        eager = fn()
    walls = []
    for i in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == calls - 1:
            got, counts, _ = counted_run(fn)
        else:
            got = fn()
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    require(name in aot.cache().live(), f"{name}: no graph after {calls} calls")
    return eager, got, counts, walls


def _same(name: str, eager, got, gate: str) -> dict:
    """A replay against its eager call: bit-equal, or within ``gate``
    ("bf16" or "f32", compare()'s tolerances) with the difference printed."""
    import torch

    pairs = list(zip(eager, got)) if isinstance(eager, tuple) else [(eager, got)]
    equal = all(torch.equal(a, b) for a, b in pairs)
    row = {"bit_equal": equal}
    if not equal:
        dtype = torch.float32 if gate == "f32" else torch.bfloat16
        cmp = compare(got if not isinstance(got, tuple) else got[0],
                      eager if not isinstance(eager, tuple) else eager[0], dtype)
        row.update(cmp)
        require(cmp["ok"], f"{name}: the replay leaves the {gate} gate of its eager call: {cmp}")
    return row


def phase_graphs(dev, canonical: dict, src, photos: list) -> dict:
    """17: the CUDA-graph cache (``aot.call_cached``) on phase 4's weights
    and photo: each program of the bf16 path (preprocess, fwd_fov,
    fwd_fnorm, fwd_mixed_b4, the two renders, the resolved stereogram)
    and fwd_fov under f32, mixed and int8, replayed against its eager call
    (``MATRIX_EYES_AOT=off``): bit-equal or within its policy's gate, the
    replay's launches equal to the eager path's; the stereogram PNG's bytes
    equal. Then graphs against eager in the same process, in turns: the
    forward's wall, device time and host time under each policy at B=1 and
    bf16 at B=4; the capture's cost and the graph pool; a clone's cost;
    ``--profile`` over a directory whose forwards replay; the server burst
    (``scripts/torch_serve_burst.py --compare-aot``, two rounds). Returns
    the replayed depth-map forward's launch counts."""
    import glob

    import torch

    from matrix_eyes_tpu_torch import aot, cli, flops, pipeline
    from matrix_eyes_tpu_torch.config import DEPTH_PRO, RuntimeConfig, parse_dtype_policy
    from matrix_eyes_tpu_torch.models.init import init_params
    from matrix_eyes_tpu_torch.output.depthmap import (
        DepthMap,
        ImageOutputFormat,
        render_depth_map,
        render_depth_map_grid,
    )
    from matrix_eyes_tpu_torch.ops.flash_attention import attention_qkv
    from matrix_eyes_tpu_torch.parallel.checks import device_ms, timed
    from matrix_eyes_tpu_torch.pt.convert import place_params

    cfg = DEPTH_PRO
    cache = aot.cache()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    forward_counts = {"attention_qkv": 3 * cfg.depth, "conv3x3": 24, "linker_scan": 0,
                      "attention_flash": 0, "threefry": 0}
    t_phase = time.perf_counter()

    def preprocess():
        return pipeline.preprocess_image(src.rgb, cfg.img_size, torch.bfloat16, dev)

    img = preprocess()
    img4 = torch.cat([img, img.flip(2), img.flip(1), img.flip(1).flip(2)])
    programs = [
        ("preprocess", preprocess, {"attention_qkv": 0, "conv3x3": 0}, "bf16"),
        ("fwd_fov", lambda: pipeline.forward_photo(cfg, params, img, None), forward_counts,
         "bf16"),
        ("fwd_fnorm", lambda: pipeline.forward_photo(cfg, params, img, 0.9),
         {"attention_qkv": 2 * cfg.depth, "conv3x3": 24}, "bf16"),  # no FOV ViT
        ("fwd_mixed_b4", lambda: pipeline.forward_batch(cfg, params, img4, [None, 0.9, None, 1.2]),
         forward_counts, "bf16"),
    ]
    results = {}
    for name, fn, want, gate in programs:
        eager, got, counts, walls = _eager_then_graphs(name, fn)
        row = _same(name, eager, got, gate)
        row.update(walls_s=walls, launches=counts)
        results[name] = row
        require(all(counts[k] == v for k, v in want.items()),
                f"{name}: a replay launched {counts}, expected {want}")
        print(f"[17] {name} bf16: replay bit-equal to eager: {row['bit_equal']}; walls s "
              f"(warm-up, capture, replay) {[round(w, 4) for w in walls]}; replay launches "
              f"{counts}")
    depth = DepthMap.new(pipeline.forward_photo(cfg, params, img, None), src.original_size)
    for name, fn in (("render_depthmap_grid",
                      lambda: aot.call_cached("render_depthmap_grid", render_depth_map_grid,
                                              (depth.data,))),
                     ("render_depthmap",
                      lambda: aot.call_cached("render_depthmap", render_depth_map,
                                              (depth.data, 3024, 4032)))):
        eager, got, counts, walls = _eager_then_graphs(name, fn)
        results[name] = _same(name, eager, got, "bf16")
        require(results[name]["bit_equal"], f"{name}: the replay's pixels differ")
        print(f"[17] {name}: replay bit-equal to eager: True; walls s "
              f"{[round(w, 4) for w in walls]}")
    # the stereograms through the user's entry: a PNG's bytes, eagerly and
    # three times through the cache at seed 7, then seed 8 through the same
    # graph (the key is the graph's input, not a launch argument)
    def stereo_png(name: str, amplitude: float, seed: int, eager: bool = False) -> tuple:
        out = os.path.join(OUT_DIR, name)
        with contextlib.ExitStack() as stack:
            if eager:
                stack.enter_context(aot.disabled())
            _, counts, _ = counted_run(lambda: depth.output_image(
                out, "synthetic", image_format=ImageOutputFormat.STEREOGRAM,
                amplitude=amplitude, seed=seed))
        with open(out, "rb") as f:
            return f.read(), counts

    for form, amplitude, program, scans in (("resolved", 0.1, "stereogram", 1),
                                            ("compact", 1 / 16, "stereogram_noise", 0)):
        pngs, calls = [], []
        for i in range(4):
            data, counts = stereo_png(f"graphs_{form}_{i}.png", amplitude, STEREO_SEED, i == 0)
            pngs.append(data)
            calls.append(counts)
        live = [k for k, e in cache._live.items() if e.name == program]
        require(live, f"the {form} stereogram's {program} has no graph")
        require(all(p == pngs[0] for p in pngs), f"a replayed {form} stereogram PNG differs "
                f"from eager")
        seed8, counts8 = stereo_png(f"graphs_{form}_seed8.png", amplitude, STEREO_SEED + 1)
        mode8 = [m for n, m in cache.modes if n == program][-1]
        eager8, _ = stereo_png(f"graphs_{form}_seed8_eager.png", amplitude, STEREO_SEED + 1,
                               eager=True)
        calls.append(counts8)
        require(all(c["linker_scan"] == scans and c["threefry"] == 1 for c in calls),
                f"{form} stereogram calls launched {calls}")
        require(mode8 == "replay" and [k for k, e in cache._live.items()
                                       if e.name == program] == live,
                f"the {form} stereogram at seed {STEREO_SEED + 1} ran {program} as {mode8}, "
                f"not as a replay of the seed-{STEREO_SEED} graph")
        require(seed8 == eager8, f"the replayed {form} stereogram at seed {STEREO_SEED + 1} "
                f"differs from its eager call")
        require(seed8 != pngs[0], f"the {form} stereogram at seed {STEREO_SEED + 1} repeats "
                f"seed {STEREO_SEED}")
        print(f"[17] stereogram ({form} PNG, amplitude {amplitude:g}): eager and three graph "
              f"calls at seed {STEREO_SEED} write the same {len(pngs[0])} bytes; seed "
              f"{STEREO_SEED + 1} replays the one live {program} graph ({len(live)} live of "
              f"that name) and writes its eager call's {len(seed8)} bytes, not seed "
              f"{STEREO_SEED}'s; linker_scan {scans} and threefry 1 launch per call")
        if form == "resolved":
            stereo_counts = calls[3]

    # fwd_fov under the other policies
    trees = {"bf16": params, "f32": canonical}
    for policy in ("mixed", "int8"):
        dtype, q8, mixed = parse_dtype_policy(policy)
        trees[policy] = place_params(canonical, dev, dtype, quantize_int8=q8, mixed_bf16=mixed)
    images = {}
    for policy in ("f32", "mixed", "int8"):
        dtype, q8, mixed = parse_dtype_policy(policy)
        image_dtype = RuntimeConfig(dtype, device=dev, quantize_int8=q8,
                                    mixed_bf16=mixed).image_dtype()
        images[policy] = pipeline.preprocess_image(src.rgb, cfg.img_size, image_dtype, dev)
        eager, got, counts, walls = _eager_then_graphs(
            "fwd_fov", lambda: pipeline.forward_photo(cfg, trees[policy], images[policy], None))
        row = _same(f"fwd_fov {policy}", eager, got, "f32" if policy == "f32" else "bf16")
        row.update(walls_s=walls, launches=counts)
        results[f"fwd_fov_{policy}"] = row
        require(counts == forward_counts, f"fwd_fov {policy}: a replay launched {counts}")
        print(f"[17] fwd_fov {policy}: replay bit-equal to eager: {row['bit_equal']}"
              f"{'' if row['bit_equal'] else ' (max_rel ' + format(row['max_rel_err'], '.3e') + ')'}"
              f"; walls s {[round(w, 4) for w in walls]}; replay launches {counts}")
    images["bf16"] = img
    print(f"[17] checks {time.perf_counter() - t_phase:.1f} s; graphs captured (name, s, pool "
          f"growth MiB): {[(n, round(s, 4), round(b / 2**20, 1)) for n, s, b in cache.captured]}")

    # graphs against eager, in turns (graphs, eager, eager, graphs). Every
    # cell runs the FOV head on each photo: B=1 is fwd_fov, and B=4 with no
    # focal length is fwd_mixed_b4 (forward_batch's branch where not every
    # f_norm is known: the FOV head over the whole batch), so each cell's
    # logical FLOPs are model_flops(cfg, batch, with_fov=True)
    cells = [("bf16", 1, 10), ("mixed", 1, 5), ("int8", 1, 5), ("f32", 1, 3), ("bf16", 4, 3)]
    peak = flops.device_peak_flops(dev)
    if peak is None:
        print(f"[17] MFU not reported: flops._PEAKS has no peak for card name "
              f"{torch.cuda.get_device_name(dev)!r}")
    timing = {}
    for policy, batch, calls in cells:
        if batch == 1:
            def fwd():
                return pipeline.forward_photo(cfg, trees[policy], images[policy], None)
        else:
            def fwd():
                return pipeline.forward_batch(cfg, trees[policy], img4, [None] * 4)
        fwd()
        fwd()  # the graph exists from here on
        runs = {"graphs": [], "eager": []}
        for mode in ("graphs", "eager", "eager", "graphs"):
            with contextlib.ExitStack() as stack:
                if mode == "eager":
                    stack.enter_context(aot.disabled())
                runs[mode].append(timed(fwd, calls))
        dev_ms = {}
        for mode in ("graphs", "eager"):
            with contextlib.ExitStack() as stack:
                if mode == "eager":
                    stack.enter_context(aot.disabled())
                dev_ms[mode] = device_ms(fwd, 2)
        cell = f"{policy}_b{batch}"
        timing[cell] = {"runs": runs, "device": dev_ms}
        for mode in ("graphs", "eager"):
            r = runs[mode]
            print(f"[17] {cell} {mode}: wall ms {[round(x['wall_ms'], 3) for x in r]}, host "
                  f"issue ms {[round(x['issue_ms'], 3) for x in r]}, host CPU ms "
                  f"{[round(x['host_cpu_ms'], 2) for x in r]}; device ms "
                  f"{dev_ms[mode][0]:.3f} in {dev_ms[mode][1]:.0f} kernels, "
                  f"{dev_ms[mode][2]:.0f} graph launches per call")
        tflop = flops.model_flops(cfg, batch=batch, with_fov=True)["total"]
        line = f"[17] {cell}: {tflop / 1e12:.4f} model TFLOP a forward; MFU "
        if peak is None:
            print(line + "not reported")
            continue
        walls_ms = [x["wall_ms"] for x in runs["graphs"]]
        on_walls = [round(100 * flops.mfu(tflop, w / 1e3, peak), 2) for w in walls_ms]
        print(line + f"{100 * flops.mfu(tflop, dev_ms['graphs'][0] / 1e3, peak):.2f} % over "
              f"the graphs' device time ({dev_ms['graphs'][0]:.3f} ms), {on_walls} % over "
              f"their walls ({[round(w, 3) for w in walls_ms]} ms), of "
              f"{peak / 1e12:.0f} TFLOP/s")
    # a replay's clones: the forward's (1, S, S) f32 and a 12 MP u8 render
    for shape, dtype in (((1, cfg.img_size, cfg.img_size), torch.float32),
                         ((3024, 4032, 3), torch.uint8)):
        t = torch.zeros(shape, dtype=dtype, device=dev)
        ms = time_ms(lambda: t.clone(), 20)
        print(f"[17] a replay's clone of {tuple(shape)} {str(dtype)[6:]}: {ms * 1e3:.1f} us")
    mem = cache.backend.memory(dev)
    print(f"[17] graph pool {mem / 2**30:.3f} GiB for {len(cache.live())} live graphs "
          f"{cache.live()}; allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")

    # --profile over three photos whose forwards replay a graph
    pdir = os.path.join(OUT_DIR, "profile_photos")
    tdir = os.path.join(OUT_DIR, "profile_trace")
    odir = os.path.join(OUT_DIR, "profile_out")
    for d in (pdir, tdir, odir):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    for i in range(3):
        shutil.copy(photos[0], os.path.join(pdir, f"p{i}.png"))
    with answered_with(params):
        _, counts, _ = counted_run(lambda: require(
            cli.main([f"--profile={tdir}", pdir, odir]) == 0, "cli.main --profile failed"))
    traces = glob.glob(os.path.join(tdir, "*.pt.trace.json"))
    require(len(traces) == 1, f"--profile wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    attn = sum("attention_wgmma_kernel" in k for k in kernels)
    replays = sum(e.get("name") == "cudaGraphLaunch" for e in events)
    print(f"[17] --profile over 3 photos: {os.path.getsize(traces[0])} bytes, {len(kernels)} "
          f"kernel events, {attn} attention_wgmma (48 a forward), {replays} cudaGraphLaunch; "
          f"launches {counts}")
    require(counts["attention_qkv"] == 3 * 72 and attn == 3 * 48 and replays > 0,
            "the --profile trace misses the kernels of the replayed graphs")

    # the server burst, graphs against eager
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_serve_burst

    from matrix_eyes_tpu_torch import api
    from PIL import Image

    photo = os.path.join(OUT_DIR, "graphs_photo.jpg")
    Image.fromarray(src.rgb).save(photo, quality=95)
    with answered_with(params):
        me = api.MatrixEyes("phase-4 weights")
    report = torch_serve_burst.main([
        "--photo", photo, "--max-batch", "4", "--requests", "16", "--concurrency", "8",
        "--compare-aot", "--rounds", "2", "--out", os.path.join(OUT_DIR, "graphs_burst.json")],
        session=me)
    for run in report["runs"]:
        for mode in ("batched", "serialized"):
            r = run[mode]
            print(f"[17] burst {r['programs']}, --max-batch={r['max_batch']}: "
                  f"{r['requests_per_s']:.3f} requests/s; p50 {r['latency_s']['p50']:.3f} s, "
                  f"p95 {r['latency_s']['p95']:.3f} s; idle {r['idle_latency_s']['median']:.3f} s;"
                  f" batch sizes {r['batch_sizes']}")
    del me, trees, params
    torch.cuda.empty_cache()
    print(f"[17] phase 17: {time.perf_counter() - t_phase:.1f} s")
    return {"graphs_depthmap_replay": results["fwd_fov"]["launches"],
            "graphs_stereogram_replay": stereo_counts}


def _graph_case_summary(tag: str, c: dict) -> str:
    """One rank's case of ``checks.run_graph_cases``: each call's mode,
    wall, launches and collectives, the capture's cost."""
    calls = "; ".join(
        f"{x['mode']} {x['wall']:.3f} s, attention_qkv {x['kernels']['attention_qkv']} conv3x3 "
        f"{x['kernels']['conv3x3']}, collectives "
        f"{ {k: v['calls'] for k, v in x['report']['collectives'].items()} }"
        for x in c["calls"])
    capture = ("none" if c["capture_s"] is None else
               f"{c['capture_s']:.3f} s, pool +{c['capture_pool_growth'] / 2**20:.1f} MiB")
    return (f"{tag} rank {c['rank']} mesh {c['mesh'][0]}x{c['mesh'][1]} "
            f"{c['calls'][0]['program']}: {calls}; replay bit-equal to eager: {c['bit_equal']}; "
            f"capture {capture}; graph pool {c['pool_bytes'] / 2**30:.3f} GiB")


def _hold_graph_case(tag: str, c: dict, cfg, n_vits: int = 3) -> None:
    """A case of ``checks.run_graph_cases`` on the card: eager, warm-up,
    capture, replay; the replay bit-equal to the eager call; every call the
    forward's launches (``n_vits`` ViTs of ``cfg.depth`` blocks: 3 with the
    FOV head, 2 without; 24 conv3x3 an image batch)."""
    modes = [x["mode"] for x in c["calls"]]
    require(modes == ["eager", "eager", "capture", "replay"],
            f"{tag}: modes {modes}, expected eager, eager, capture, replay")
    require(c["bit_equal"], f"{tag}: the replay differs from the eager call")
    for x in c["calls"]:
        got = (x["kernels"]["attention_qkv"], x["kernels"]["conv3x3"])
        require(got == (n_vits * cfg.depth, 24),
                f"{tag}: a {x['mode']} call launched {got} attention_qkv/conv3x3")


def phase_mesh_graphs(dev, src, ref_inv, weights: str, gloo_modes: dict) -> dict:
    """18: the mesh's forwards through its CUDA-graph cache
    (``aot.mesh_cache``): (a) NCCL's own collectives captured in a graph;
    (b) the 1x1 NCCL mesh's forward through the mesh cache, bit-equal to
    phase 4; (c) phase 16's gloo ranks ran every forward eagerly; (d) NCCL
    1x2 and 2x1 (2x2 on four cards) where the machine has the cards.
    Returns rank 0's replay launches by mesh."""
    import torch

    from matrix_eyes_tpu_torch import pipeline
    from matrix_eyes_tpu_torch.config import DEPTH_PRO
    from matrix_eyes_tpu_torch.parallel import launch
    from matrix_eyes_tpu_torch.parallel.checks import run_collectives_capture, run_graph_cases

    cfg = DEPTH_PRO
    t_phase = time.perf_counter()
    # a. dist.all_reduce and dist.all_gather_into_tensor inside a graph
    (r,) = launch(run_collectives_capture, (1, 1), timeout=MESH_TIMEOUT)
    modes = [c["mode"] for c in r["calls"]]
    print(f"[18a] NCCL world of {r['world']} rank: all_reduce + all_gather_into_tensor of "
          f"2^20 f32 through a GraphCache: modes {modes}, each equal to the eager result of "
          f"its input {[c['equal'] for c in r['calls']]}; captured (name, s, pool growth B) "
          f"{r['captured']}")
    require(r["backend"] == "nccl" and not r["foreign_modules"], f"part a ran on {r['backend']}")
    require(modes == ["eager", "capture", "replay", "replay"]
            and all(c["equal"] for c in r["calls"]),
            "NCCL's collectives did not capture, or a replay differs from eager")

    # b. the 1x1 NCCL mesh's forwards through the mesh cache: fwd_fov, then
    # fwd_fnorm and fwd_fnorm_b2, each case's graphs freed with its weights
    # before the next one captures into the mesh's pool
    img = pipeline.preprocess_image(src.rgb, cfg.img_size, torch.bfloat16, dev).cpu()
    t0 = time.perf_counter()
    (r,) = launch(run_graph_cases, (1, 1), [
        dict(cfg=cfg, params=weights, img=img, timing=5),
        dict(cfg=cfg, params=weights, img=img, f_norms=[0.9]),
        dict(cfg=cfg, params=weights, img=torch.cat([img, img.flip(2)]), f_norms=[0.9, 1.2])],
        timeout=MESH_TIMEOUT)
    c = r["cases"][0]
    print(f"[18b] NCCL 1x1 ({time.perf_counter() - t0:.1f} s with start-up); foreign modules "
          f"{r['foreign_modules']}")
    require(r["backend"] == "nccl" and not r["foreign_modules"],
            f"part b ran on {r['backend']} with {r['foreign_modules']}")
    print(_graph_case_summary("[18b]", c))
    _hold_graph_case("[18b] NCCL 1x1", c, cfg)
    equal = torch.equal(c["inv"], ref_inv[0].cpu())
    print(f"[18b] replayed inverse depth == phase 4's: {equal}")
    require(equal, "the 1x1 mesh's replay differs from phase 4's inverse depth")
    for known in r["cases"][1:]:
        print(_graph_case_summary("[18b]", known))
        _hold_graph_case(f"[18b] NCCL 1x1 {known['calls'][0]['program']}", known, cfg, n_vits=2)
    t = c["timing"]
    for mode in ("graphs", "eager"):
        runs = t["runs"][mode]
        print(f"[18b] 1x1 {mode}: wall ms {[round(x['wall_ms'], 3) for x in runs]}, host issue "
              f"ms {[round(x['issue_ms'], 3) for x in runs]}, host CPU ms "
              f"{[round(x['host_cpu_ms'], 2) for x in runs]}; device ms "
              f"{t['device'][mode][0]:.3f} in {t['device'][mode][1]:.0f} kernels, by family "
              f"{ {k: round(v, 3) for k, v in sorted(t['device'][mode][3].items())} }")
    counts = {"mesh_graphs_nccl_1x1_replay": c["calls"][3]["kernels"]}

    # c. gloo stays eager: phase 16's entry points on the 2x2 gloo world
    for name, ranks in gloo_modes.items():
        print(f"[18c] gloo 2x2 {name}: forward modes by rank {ranks}")
        require(all(ranks) and all(m == "eager" for r_ in ranks for m in r_),
                f"gloo 2x2 {name}: a forward ran in another mode than eager: {ranks}")

    # d. NCCL across cards
    n_cards = torch.cuda.device_count()
    worlds = ([((1, 2), [dict(cfg=cfg, params=weights, img=img),
                         dict(cfg=cfg, params=weights, img=img, model=1)])] if n_cards >= 2
              else [])
    if n_cards >= 4:
        worlds.append(((2, 2), [dict(cfg=cfg, params=weights, img=img)]))
    for shape, cases in worlds:
        results = launch(run_graph_cases, shape, cases, timeout=MESH_TIMEOUT)
        require(all(res["backend"] == "nccl" and not res["foreign_modules"] for res in results),
                f"[18d] {shape}: a rank ran without NCCL or loaded jax")
        for i in range(len(cases)):
            rank_cases = [res["cases"][i] for res in results]
            for rc_ in rank_cases:
                print(_graph_case_summary("[18d]", rc_))
                _hold_graph_case(f"[18d] {rc_['mesh']}", rc_, cfg)
            res = compare(rank_cases[0]["inv"][None], ref_inv.cpu(), torch.bfloat16)
            require(res["ok"], f"[18d] {rank_cases[0]['mesh']}: outside the bf16 gate: {res}")
            data, model = rank_cases[0]["mesh"]
            counts[f"mesh_graphs_nccl_{data}x{model}_replay"] = rank_cases[0]["calls"][3]["kernels"]
    if n_cards < 2:
        print(f"[18d] {n_cards} card: NCCL 1x2, 2x1 and the four-card meshes run in "
              "scripts/torch_mesh_check.py --graphs")
    for c_ in counts.values():
        c_.setdefault("linker_scan", 0)
        c_.setdefault("threefry", 0)
    print(f"[18] phase 18: {time.perf_counter() - t_phase:.1f} s")
    return counts


def _vit_elementwise_inputs(kernel: str, shape: tuple, dtypes: tuple, dev) -> tuple:
    """Seeded operands: normal values at scales 1e-3 to 1e3 (GELU's input),
    a residual stream, a branch output and LayerScale values near 0.1."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    dt = [getattr(torch, {"f32": "float32", "bf16": "bfloat16", "f16": "float16"}[d])
          for d in dtypes]

    def normal(shp, scale):
        return torch.randn(shp, generator=gen, device=dev) * scale

    if kernel == "gelu":
        x = normal(shape, 1.0) * torch.exp(
            torch.empty(shape, device=dev).uniform_(-7.0, 7.0, generator=gen))
        return (x.to(dt[0]),)
    return (normal(shape, 1.0).to(dt[0]), normal(shape, 1.0).to(dt[1]),
            normal(shape[-1:], 0.1).to(dt[2]))


def vit_elementwise_row(dev, kernel: str, shape: tuple, dtypes: tuple, timed: bool) -> dict:
    """One kernel against its plain version (the PyTorch chain on the card)
    at shape, bit for bit; when ``timed``, the kernel's and the chain's
    time by CUDA events and by the profiler, and the byte bound: each
    operand read once at its dtype and the output written once."""
    import torch

    from matrix_eyes_tpu_torch.ops import nn
    from matrix_eyes_tpu_torch.parallel.checks import device_ms

    plain = getattr(nn, f"{kernel}_plain")
    args = _vit_elementwise_inputs(kernel, shape, dtypes, dev)
    if kernel == "gelu":  # in place, as the ViT block calls it, on a copy kept for the timing
        work = args[0].clone()
        fn = lambda: nn.gelu_(work)  # noqa: E731
        got = nn.gelu_(args[0].clone())
    else:
        fn = lambda: nn.scaled_residual(*args)  # noqa: E731
        got = fn()
    want = plain(*args)
    torch.cuda.synchronize()
    bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
    differing = int((got.view(bits) != want.view(bits)).sum().item())
    res = {"shape": f"{'x'.join(map(str, shape))} {'/'.join(dtypes)}",
           "ok": got.dtype == want.dtype and differing == 0, "differing": differing}
    nbytes = sum(a.numel() * a.element_size() for a in args) + got.numel() * got.element_size()
    res["bound_ms"], res["bound_by"] = nbytes / PEAK_BYTES_S * 1e3, "bytes"
    if timed:
        reps = 20
        res["ms"] = time_ms(fn, reps)
        res["device_ms"] = device_ms(fn, reps)[0]
        res["chain_ms"] = time_ms(lambda: plain(*args), reps)
        res["chain_device_ms"] = device_ms(lambda: plain(*args), reps)[0]
        res["bound_share"] = res["bound_ms"] / res["device_ms"]
    times = (f"ms={res['ms']:.4f} device_ms={res['device_ms']:.4f} chain_ms={res['chain_ms']:.4f} "
             f"chain_device_ms={res['chain_device_ms']:.4f} bound share "
             f"{100 * res['bound_share']:.1f}% " if timed else "")
    print(f"[19] {kernel} {res['shape']}: {nbytes / 1e9:.4f} GB, {times}"
          f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) "
          f"{'ok (bit-exact)' if res['ok'] else 'FAIL: %d elements differ' % res['differing']}")
    return res


def phase_vit_elementwise(dev) -> dict:
    """The ViT block's one-pass GELU and LayerScale residual add against
    their chains at ``VIT_ELEMENTWISE_SHAPES``, then one DEPTH_PRO
    ``fwd_mixed_b4`` forward under the mixed policy (phase 4's seed),
    eager, captured and replayed, each counted. Returns the rows and the
    counts."""
    import torch
    import torch.nn.functional as F

    from matrix_eyes_tpu_torch import pipeline
    from matrix_eyes_tpu_torch.config import DEPTH_PRO
    from matrix_eyes_tpu_torch.models.init import init_params
    from matrix_eyes_tpu_torch.pt.convert import place_params

    rows = [vit_elementwise_row(dev, *row) for row in VIT_ELEMENTWISE_SHAPES]
    bad = [r["shape"] for r in rows if not r["ok"]]
    require(not bad, f"vit_elementwise kernels differ from their chains at {bad}")

    cfg = DEPTH_PRO
    canonical = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.float32)
    params = place_params(canonical, dev, torch.bfloat16, mixed_bf16=True)
    del canonical
    gen = torch.Generator(device=dev).manual_seed(4)
    img = torch.rand((4, cfg.img_size, cfg.img_size, 3), generator=gen, device=dev) * 2 - 1
    f_norms = [0.8, None, 0.6, 0.7]

    real_gelu = F.gelu

    def no_gelu(x, *args, **kwargs):
        require(not x.is_cuda, "F.gelu reached on a CUDA tensor inside the forward")
        return real_gelu(x, *args, **kwargs)

    counts = []
    F.gelu = no_gelu
    try:
        for _ in range(3):  # eager, capture, replay
            inv, _, _ = counted_run(lambda: pipeline.forward_batch(cfg, params, img, f_norms))
            counts.append({"gelu": sum(launches_by("gelu").values()),
                           "scaled_residual": sum(launches_by("scaled_residual").values()),
                           "gelu_by_shape": {str(k): v for k, v in launches_by("gelu").items()},
                           "scaled_residual_by_shape": {
                               str(k): v for k, v in launches_by("scaled_residual").items()}})
    finally:
        F.gelu = real_gelu
    require(bool(torch.isfinite(inv).all()), "fwd_mixed_b4: non-finite inverse depth")
    for c in counts:
        print(f"[19] fwd_mixed_b4 (mixed policy): gelu {c['gelu']} launches "
              f"{c['gelu_by_shape']}, scaled_residual {c['scaled_residual']} launches "
              f"{c['scaled_residual_by_shape']}")
    want = (3 * cfg.depth, 6 * cfg.depth)
    require(all((c["gelu"], c["scaled_residual"]) == want for c in counts),
            f"fwd_mixed_b4 launched gelu/scaled_residual {counts}, expected {want} per call")
    del params, img, inv
    torch.cuda.empty_cache()
    return {"rows": rows, "fwd_mixed_b4": counts[0]}


def phase_dav2(dev) -> dict:
    """Depth Anything V2 Large on the card: the library's K/V path at
    ``KV_PATH_CASES``, then ``MatrixEyes.inverse_depth_batch`` over
    ``DAV2_BATCH`` synthetic 1920x1080 frames three times (eager, capture,
    replay), each counted from 0. Returns the first call's launches
    ({kernel: launches})."""
    import numpy as np
    import torch

    from matrix_eyes_tpu_torch import aot, api
    from matrix_eyes_tpu_torch.config import DAV2_LARGE
    from matrix_eyes_tpu_torch.models.init import init_params
    from matrix_eyes_tpu_torch.ops.flash_attention import kv_path
    from matrix_eyes_tpu_torch.pt.convert import place_params

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
    paths = [(n, d, dt, kv_path(n, d, dtypes[dt]), want) for n, d, dt, want in KV_PATH_CASES]
    print(f"[20] attention K/V path by (keys, D, dtype): "
          f"{[(n, d, dt, got) for n, d, dt, got, _w in paths]}")
    require(all(got == want for *_k, got, want in paths),
            f"the library's K/V paths {paths} differ from KV_PATH_CASES")

    cfg = DAV2_LARGE
    canonical = init_params(cfg, torch.Generator(device=dev).manual_seed(20), dev, torch.float32)
    params = place_params(canonical, dev, torch.bfloat16)
    del canonical

    def answer(_path, dtype, device, **_kw):
        require(dtype == torch.bfloat16, f"DAv2 weights asked for in {dtype}")
        return cfg, params

    real_load = api.load_checkpoint
    api.load_checkpoint = answer
    try:
        me = api.MatrixEyes("random weights", dtype="bf16", device=dev, cfg=cfg)
    finally:
        api.load_checkpoint = real_load
    rng = np.random.RandomState(20)
    frames = [rng.randint(0, 256, (1080, 1920, 3), dtype=np.uint8) for _ in range(DAV2_BATCH)]
    h, w = cfg.input_hw(1080, 1920)
    n = (h // cfg.patch_size) * (w // cfg.patch_size) + 1
    want_attn = {(DAV2_BATCH, n, cfg.num_heads, cfg.head_dim, "bfloat16", "streamed"): cfg.depth}
    want_conv = {(DAV2_BATCH, H, W, cin, cout, torch.bfloat16, relu_in, n_skips, bias): k
                 for H, W, cin, cout, relu_in, n_skips, bias, k in DAV2_CONVS}
    want_resample = {(*s, "bfloat16"): 1 for s in DAV2_RESAMPLES}
    outs, runs = [], []
    for _ in range(3):  # eager, capture, replay
        inv, counts, conv = counted_run(lambda: me.inverse_depth_batch(frames))
        outs.append(inv)
        resample = launches_by("resize_bilinear")
        runs.append({"counts": dict(counts, resize_bilinear=sum(resample.values())),
                     "attention_by_shape": launches_by("attention_qkv"),
                     "conv3x3_by_shape": conv,
                     "gelu": sum(launches_by("gelu").values()),
                     "scaled_residual": sum(launches_by("scaled_residual").values()),
                     "resize_bilinear_by_shape": resample, "uploads": launches_by("upload"),
                     "mode": aot.cache().modes[-1]})
    for r in runs:
        print(f"[20] dav2 inverse_depth_batch x{DAV2_BATCH} {r['mode']}: launches {r['counts']}, "
              f"gelu {r['gelu']}, scaled_residual {r['scaled_residual']}; attention by "
              f"(B, N, H, D, dtype, path) {r['attention_by_shape']}; conv3x3 by shape "
              f"{len(r['conv3x3_by_shape'])} shapes, {sum(r['conv3x3_by_shape'].values())} "
              f"launches; resize_bilinear by (B, H, W, C, out_h, out_w, dtype) "
              f"{r['resize_bilinear_by_shape']}; uploads by path {r['uploads']}")
    modes = [r["mode"] for r in runs]
    require(modes == [(f"dav2_fwd_b{DAV2_BATCH}", m) for m in ("eager", "capture", "replay")],
            f"dav2 forward modes {modes}, expected eager, capture, replay")
    for r in runs:
        require(r["attention_by_shape"] == want_attn,
                f"dav2 attention launches {r['attention_by_shape']}, expected {want_attn}")
        require(r["conv3x3_by_shape"] == want_conv,
                f"dav2 conv3x3 launches by shape {r['conv3x3_by_shape']}, expected {want_conv}")
        require((r["gelu"], r["scaled_residual"]) == (cfg.depth, 2 * cfg.depth),
                f"dav2 launched gelu/scaled_residual {r['gelu']}/{r['scaled_residual']}, "
                f"expected {cfg.depth}/{2 * cfg.depth}")
        require(r["resize_bilinear_by_shape"] == want_resample,
                f"dav2 resize_bilinear launches by shape {r['resize_bilinear_by_shape']}, "
                f"expected {want_resample}")
        require(r["uploads"] == {("pinned",): DAV2_BATCH},
                f"dav2 uploads by path {r['uploads']}, expected {DAV2_BATCH} pinned")
    require(outs[0].shape == (DAV2_BATCH, h, w) and outs[0].dtype == np.float32,
            f"dav2 inverse depth {outs[0].shape} {outs[0].dtype}, expected "
            f"{(DAV2_BATCH, h, w)} float32")
    require(bool(np.isfinite(outs[0]).all()), "dav2: non-finite inverse depth")
    require(np.array_equal(outs[0], outs[2]), "dav2: the replay differs from the eager call")
    print(f"[20] dav2 ({DAV2_BATCH}, {h}, {w}) f32, range [{outs[0].min():.4g}, "
          f"{outs[0].max():.4g}], replay == eager bit for bit")
    del me, params
    torch.cuda.empty_cache()
    return runs[0]["counts"]


def resample_row(dev, b, h, w, c, out_h, out_w, dtype, offset, timed) -> dict:
    """``nn.resize_bilinear`` (the kernel) against its plain version,
    ``F.interpolate`` on the channels-last view, bit for bit; when
    ``timed``, both by CUDA events and by the profiler, and the byte bound:
    the input read once and the output written once at 3.35 TB/s."""
    import torch

    from matrix_eyes_tpu_torch.ops import nn
    from matrix_eyes_tpu_torch.parallel.checks import device_ms

    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[dtype]
    gen = torch.Generator(device=dev).manual_seed(b * h * w * c + out_h * out_w)
    n = b * h * w * c
    x = (torch.randn(n + offset, generator=gen, device=dev) * 3).to(dt)[offset:].view(b, h, w, c)
    got = nn.resize_bilinear(x, out_h, out_w)
    want = nn.resize_bilinear_plain(x, out_h, out_w)
    torch.cuda.synchronize()
    bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
    differing = int((got.view(bits) != want.view(bits)).sum().item())
    shape = f"{b}x{h}x{w}x{c} -> {out_h}x{out_w} {dtype}" + (f" +{offset}" if offset else "")
    res = {"shape": shape, "ok": got.shape == want.shape and got.dtype == want.dtype
           and differing == 0, "differing": differing, "elements": got.numel()}
    nbytes = (x.numel() + got.numel()) * x.element_size()
    res["bound_ms"], res["bound_by"] = nbytes / PEAK_BYTES_S * 1e3, "bytes"
    if timed:
        reps = 20
        res["ms"] = time_ms(lambda: nn.resize_bilinear(x, out_h, out_w), reps)
        res["device_ms"] = device_ms(lambda: nn.resize_bilinear(x, out_h, out_w), reps)[0]
        res["plain_ms"] = time_ms(lambda: nn.resize_bilinear_plain(x, out_h, out_w), reps)
        res["plain_device_ms"] = device_ms(lambda: nn.resize_bilinear_plain(x, out_h, out_w),
                                           reps)[0]
        res["bound_share"] = res["bound_ms"] / res["device_ms"]
        res["plain_bound_share"] = res["bound_ms"] / res["plain_device_ms"]
    times = (f"ms={res['ms']:.4f} device_ms={res['device_ms']:.4f} "
             f"F.interpolate ms={res['plain_ms']:.4f} device_ms={res['plain_device_ms']:.4f} "
             f"bound share {100 * res['bound_share']:.1f}% (F.interpolate "
             f"{100 * res['plain_bound_share']:.1f}%) " if timed else "")
    print(f"[21] resize_bilinear {shape}: {nbytes / 1e6:.2f} MB, {times}"
          f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) "
          f"{'ok (bit-exact)' if res['ok'] else 'FAIL: %d elements differ' % differing}")
    return res


def phase_resample(dev) -> dict:
    """The bilinear resampling kernel against ``F.interpolate`` at
    ``RESAMPLE_SHAPES``. Returns the rows."""
    import torch

    rows = [resample_row(dev, *row) for row in RESAMPLE_SHAPES]
    bad = [r["shape"] for r in rows if not r["ok"]]
    require(not bad, f"resize_bilinear differs from F.interpolate at {bad}")
    torch.cuda.empty_cache()
    return {"rows": rows}


def _host_ms(fn, reps: int) -> float:
    """Warm host-clock ms a call of fn, the card synchronised after the
    calls: what the caller waits for the last call's work."""
    import torch

    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def upload_row(dev, shape: tuple) -> dict:
    """``pipeline.upload`` of a seeded u8 photo of ``shape`` against
    ``torch.tensor(rgb, device=dev)``, bit for bit (contiguous, read-only,
    a strided view), one count of ("upload", "pinned"); then warm rates in
    GB/s (see phase 22)."""
    import numpy as np
    import torch

    from matrix_eyes_tpu_torch import pipeline
    from matrix_eyes_tpu_torch.ops import _build

    h, w, c = shape
    rng = np.random.RandomState(22)
    rgb = rng.randint(0, 256, shape, dtype=np.uint8)
    frozen = rgb.copy()
    frozen.flags.writeable = False
    strided = rng.randint(0, 256, (h, w + 8, c), dtype=np.uint8)[:, 4:w + 4]
    same = {}
    for name, a in (("contiguous", rgb), ("read_only", frozen), ("strided", strided)):
        _build.reset()
        got = pipeline.upload(a, dev)
        counts = dict(_build.launches("upload"))
        same[name] = bool(torch.equal(got, torch.tensor(a, device=dev)))
        require(counts == {("pinned",): 1}, f"upload {shape} {name}: counts {counts}")
    require(all(same.values()), f"pinned upload {shape} differs from torch.tensor: {same}")

    nbytes = rgb.nbytes
    host = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(shape, dtype=torch.uint8, device=dev)
    host_np = host.numpy()
    ms = {
        "stage": _host_ms(lambda: pipeline.stage(rgb, host), UPLOAD_REPS),
        "stage_torch_openmp": _host_ms(lambda: host.copy_(torch.from_numpy(rgb)), UPLOAD_REPS),
        "stage_numpy": _host_ms(lambda: host_np.__setitem__(Ellipsis, rgb), UPLOAD_REPS),
        "dma_events": time_ms(lambda: dst.copy_(host, non_blocking=True), UPLOAD_REPS),
        "dma_host": _host_ms(lambda: dst.copy_(host, non_blocking=True), UPLOAD_REPS),
        "upload_host": _host_ms(lambda: pipeline.upload(rgb, dev), UPLOAD_REPS),
        "upload_events": time_ms(lambda: pipeline.upload(rgb, dev), UPLOAD_REPS),
        "pageable_host": _host_ms(lambda: torch.tensor(rgb, device=dev), UPLOAD_REPS),
        "pageable_events": time_ms(lambda: torch.tensor(rgb, device=dev), UPLOAD_REPS),
    }
    row = {"shape": list(shape), "bytes": nbytes, "bit_equal": same,
           "threads": torch.get_num_threads(),
           "ms": {k: round(v, 4) for k, v in ms.items()},
           "gb_s": {k: round(nbytes / v / 1e6, 2) for k, v in ms.items()}}
    print(f"[22] upload {row}")
    return row


def phase_upload(dev) -> dict:
    """The photo's upload at ``UPLOAD_SHAPES`` (see phase 22). Returns the
    rows."""
    import torch

    rows = [upload_row(dev, shape) for shape in UPLOAD_SHAPES]
    torch.cuda.empty_cache()
    return {"rows": rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an H100", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "matrix_eyes_tpu_torch")):
        print("chip_smoke: run it from the root of a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from matrix_eyes_tpu_torch.config import DEPTH_PRO, configure_precision
    from matrix_eyes_tpu_torch.models.init import init_params

    configure_precision()
    dev = torch.device("cuda", 0)
    smi = phase_environment()
    sass = phase_build()
    hot, conv_rows = phase_kernels(dev)
    by_path = {}
    by_path["depthmap_png"], conv_shapes, inv_bf16, params, src = phase_main_path(dev)
    hot["conv3x3"]["per_forward"] = conv_per_forward(conv_rows, conv_shapes, torch.bfloat16, 4)
    by_path["depthmap_png_f32"], conv_shapes, inv_f32 = phase_f32_path(dev, src)
    hot["conv3x3"]["per_forward_f32"] = conv_per_forward(conv_rows, conv_shapes, torch.float32,
                                                         5)
    bf16_gap = rel_gap(inv_bf16, inv_f32)
    phase_end_to_end(dev)
    by_path.update(phase_stereogram(dev, params, src))
    photos = write_photos(src)
    by_path["mesh_obj"] = phase_mesh(dev, params, src, photos[0])
    by_path["batch4"] = phase_batch(dev, params, photos)
    del params
    torch.cuda.empty_cache()
    canonical = init_params(DEPTH_PRO, torch.Generator(device=dev).manual_seed(0), dev,
                            torch.float32)  # phase 4's seed, before its rounding to bf16
    for phase, policy in ((10, "f16"), (11, "mixed"), (12, "int8")):
        by_path[f"depthmap_png_{policy}"], per_forward = phase_policy(
            dev, policy, phase, canonical, src, photos[0], inv_f32, bf16_gap, conv_rows)
        if policy == "f16":
            hot["conv3x3_f16"]["per_forward"] = per_forward
    phase_policies_mid(dev)
    by_path["serve"], by_path["serve_batch4"] = phase_serve(dev, canonical, src, photos)
    by_path["warm_start"] = phase_warm_start(dev, canonical, photos[0])
    weights = write_weights(dev)
    try:
        mesh_counts, gloo_modes = phase_multi_device(dev, src, inv_bf16, photos, weights)
        by_path.update(mesh_counts)
        by_path.update(phase_graphs(dev, canonical, src, photos))
        del canonical
        torch.cuda.empty_cache()
        by_path.update(phase_mesh_graphs(dev, src, inv_bf16, weights, gloo_modes))
    finally:
        os.remove(weights)
    vit_elementwise = phase_vit_elementwise(dev)
    by_path["dav2_frames_b8"] = phase_dav2(dev)
    resample = phase_resample(dev)
    upload = phase_upload(dev)
    foreign = [m for m in sys.modules if m.split(".")[0] in ("jax", "matrix_eyes_tpu")]
    require(not foreign, f"the port imported jax or the JAX package: {foreign[:5]}")

    kernels = []
    for name, source, replaces, path in (
            ("attention_qkv", "matrix_eyes_tpu_torch/csrc/attention_qkv.cu",
             "matrix_eyes_tpu/ops/flash_attention.py:229", "depthmap_png"),
            ("conv3x3", "matrix_eyes_tpu_torch/csrc/conv3x3.cu",
             "matrix_eyes_tpu/ops/conv3x3.py:187", "depthmap_png"),
            ("linker_scan", "matrix_eyes_tpu_torch/csrc/linker_scan.cu",
             "matrix_eyes_tpu/ops/stereogram_kernel.py:58", "resolved_png"),
            ("attention_flash", "matrix_eyes_tpu_torch/csrc/attention_qkv.cu",
             "matrix_eyes_tpu/ops/flash_attention.py:159", "depthmap_png"),
            # not a TPU kernel: XLA draws the JAX package's noise
            ("threefry", "matrix_eyes_tpu_torch/csrc/threefry.cu",
             "matrix_eyes_tpu/ops/stereogram.py:95", "resolved_png")):
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": by_path[path][name], "launches_path": path,
                        "launches_by_path": {p: c[name] for p, c in by_path.items()},
                        "max_abs_err": hot[name]["max_abs_err"],
                        "ms": hot[name]["ms"], "plain_ms": hot[name]["plain_ms"],
                        "bound_ms": hot[name]["bound_ms"], "bound_by": hot[name]["bound_by"],
                        "library_ms": hot[name]["library_ms"], "shape": hot[name]["shape"]})
        for key in ("per_forward", "per_forward_f32"):
            if key in hot[name]:
                kernels[-1][key] = hot[name][key]
        if name == "conv3x3":  # the hot shape under --dtype f32
            kernels[-1]["f32"] = {k: hot["conv3x3_f32"][k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "bound_cuda_core_ms")}
        row_keys = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by")
        if name == "threefry":
            kernels[-1]["tpu_kernel"] = False
            kernels[-1]["device_ms"] = hot[name]["device_ms"]
            kernels[-1]["host_draw_upload_ms"] = hot[name]["host_draw_upload_ms"]
            kernels[-1]["sass_instructions_per_thread"] = (
                None if sass is None else sum(sass.values()))
            kernels[-1]["rows"] = [{k: row[k] for k in (
                "shape", "max_abs_err", "ms", "device_ms", "plain_ms", "host_draw_upload_ms",
                "bound_ms", "bound_by")} for row in hot["threefry_rows"]]
            continue
        if name != "linker_scan":  # the f16 build at the hot shape (--dtype f16)
            f16 = hot[f"{name}_f16"]
            kernels[-1]["f16"] = {k: f16[k] for k in row_keys}
            if "per_forward" in f16:
                kernels[-1]["f16"]["per_forward"] = f16["per_forward"]
        if name == "attention_qkv":  # the FOV ViT's f32 call, 24 launches per forward
            fov = hot["attention_qkv_fov_f32"]
            kernels[-1]["fov_f32"] = {k: fov[k] for k in row_keys + ("bound_cuda_core_ms",)}
            # a batch of four photos: the patch ViT and the FOV ViT
            kernels[-1]["batch4"] = {k: hot["attention_qkv_batch4"][k] for k in row_keys}
            for key in ("batch4_fov_f32", "batch4_f32"):
                kernels[-1][key] = {k: hot[f"attention_qkv_{key}"][k]
                                    for k in row_keys + ("bound_cuda_core_ms",)}
            # the shapes a rank of a sharded mesh runs (phase 16)
            kernels[-1]["per_shard"] = [{k: row[k] for k in row_keys}
                                        for row in hot["attention_qkv_per_shard"]]
        if name == "conv3x3":
            kernels[-1]["batch4"] = {k: hot["conv3x3_batch4"][k] for k in row_keys}
            kernels[-1]["batch4_f32"] = {k: hot["conv3x3_batch4_f32"][k]
                                         for k in row_keys + ("bound_cuda_core_ms",)}
            kernels[-1]["past_2e31"] = {k: hot["conv3x3_past_2e31"][k] for k in row_keys}
    # not TPU kernels: XLA fused these chains into the ViT block's programs
    for name in ("gelu", "scaled_residual"):
        kernels.append({"name": name, "route": "cuda", "tpu_kernel": False,
                        "source": "matrix_eyes_tpu_torch/csrc/vit_elementwise.cu",
                        "replaces": "matrix_eyes_tpu/models/vit.py::block_forward",
                        "launches": vit_elementwise["fwd_mixed_b4"][name],
                        "launches_path": "fwd_mixed_b4",
                        "rows": [r for r, (k, *_rest) in zip(vit_elementwise["rows"],
                                                            VIT_ELEMENTWISE_SHAPES) if k == name]})
    # not a TPU kernel: the JAX package has no Depth Anything V2
    kernels.append({"name": "resize_bilinear", "route": "cuda", "tpu_kernel": False,
                    "source": "matrix_eyes_tpu_torch/csrc/resample.cu", "replaces": None,
                    "launches": by_path["dav2_frames_b8"]["resize_bilinear"],
                    "launches_path": "dav2_frames_b8", "rows": resample["rows"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"upload": upload["rows"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
