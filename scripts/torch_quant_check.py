#!/usr/bin/env python3
"""The int8 policy's two layout and rounding choices, checked on one CUDA
card (``matrix_eyes_tpu_torch/ops/quant.py``).

    python3 scripts/torch_quant_check.py

1. The quantizers on the card against the CPU at the DEPTH_PRO patch
   ViT's shapes (24 stacked (1024, 3072) f16 weights; 20195 bf16 tokens of
   1024): codes and scales must be equal. Beside them, the scales computed
   with a division by the Python number 127 on the card, which PyTorch
   runs as a product with its reciprocal: how many differ from the CPU's.
2. ``torch._int_mm`` at the qkv and fc1 shapes with the code matrix as
   the port stores it, (out, in) handed over transposed, against an
   (in, out) matrix: exact against a float64 product, and ms by CUDA
   events.

Prints the card's name and power limit; exits 1 if a check fails.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    from matrix_eyes_tpu_torch.ops.quant import quantize_act, quantize_weight

    if not torch.cuda.is_available():
        print("torch_quant_check: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    ok = True
    w = (torch.randn(24, 1024, 3072, generator=gen) * 0.03).half()
    x = torch.randn(20195, 1024, generator=gen).bfloat16()
    qc, sc = quantize_weight(w)
    qg, sg = quantize_weight(w.to(dev))
    ac, xc = quantize_act(x)
    ag, xg = quantize_act(x.to(dev))
    same = [torch.equal(qc, qg.cpu()), torch.equal(sc, sg.cpu()), torch.equal(ac, ag.cpu()),
            torch.equal(xc, xg.cpu())]
    ok &= all(same)
    reciprocal = (w.to(dev).float().abs().amax(-2).clamp(min=1e-12) / 127.0).cpu()
    print(f"quantize_weight card == CPU: codes {same[0]}, scales {same[1]}; quantize_act: "
          f"codes {same[2]}, scales {same[3]}; scales divided by the number 127 on the card "
          f"differ from the CPU's in {int((reciprocal != sc).sum())} of {sc.numel()}")
    for name, (m, k, n) in (("qkv", (20195, 1024, 3072)), ("fc1", (20195, 1024, 4096))):
        a = torch.randint(-127, 128, (m, k), device=dev, dtype=torch.int8)
        w_out_in = torch.randint(-127, 128, (n, k), device=dev, dtype=torch.int8)
        w_in_out = w_out_in.t().contiguous()
        want = a.double() @ w_in_out.double()
        for layout, b in (("(out, in) transposed, as stored", w_out_in.t()),
                          ("(in, out)", w_in_out)):
            exact = torch.equal(torch._int_mm(a, b).double(), want)
            ok &= exact
            print(f"_int_mm {name} {m}x{k}x{n}, weight {layout}: exact {exact}, "
                  f"{_ms(lambda: torch._int_mm(a, b)):.4f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
