"""B4's bf16 error as a share of its tolerance, at every bf16 card-test
shape and ``chip_smoke.py``'s bf16 case.

    PYTHONPATH=src python -m repro_torch.launch.flash_shares

For each shape (B, T, S, H, Hkv, D, causal) and three seeds: max |kernel -
plain| / (1e-2 * max(1, max |plain|)), the tolerance of the card tests and
``chip_smoke.py``.  The number of bf16 terms P takes against bf16 values is
``kBf16QPTerms`` in ``csrc/attn_tile.cuh``: the fewest that keep every
share under one half (PERF.md, §6).
"""
from __future__ import annotations

import sys

import torch

# tests/test_torch_cuda_kernels.py's bf16 flash shapes, then chip_smoke.py's
SHAPES = [(2, 37, 37, 4, 2, 16, True), (1, 64, 64, 16, 8, 64, True),
          (1, 300, 300, 32, 32, 128, True), (2, 129, 129, 6, 2, 32, True),
          (1, 1, 1, 4, 1, 64, True), (1, 128, 128, 16, 8, 64, False),
          (1, 1024, 1024, 8, 4, 64, False),
          (2, 70, 70, 8, 2, 8, True), (1, 100, 100, 8, 4, 80, True),
          (1, 150, 150, 4, 2, 256, True), (2, 45, 100, 6, 2, 64, True),
          (1, 128, 1024, 16, 8, 64, False), (1, 37, 37, 24, 8, 48, True),
          (1, 200, 200, 8, 8, 64, True), (1, 200, 200, 16, 8, 64, True),
          (2, 99, 99, 16, 4, 32, True), (1, 77, 77, 64, 8, 128, True),
          (1, 2048, 2048, 16, 8, 64, True)]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_shares: no CUDA device available")
    from repro_torch.kernels import flash_attention as FA

    dev = torch.device("cuda")
    worst = 0.0
    for b, t, s, h, hkv, d, causal in SHAPES:
        for seed in (t + h, b + t + s + h + hkv + d, t + h + d):
            gen = torch.Generator(device=dev).manual_seed(seed)
            q, k, v = (torch.randn(b, n, hh, d, generator=gen,
                                   device=dev).bfloat16()
                       for n, hh in ((t, h), (s, hkv), (s, hkv)))
            out = FA.flash_attention_cuda(q, k, v, causal=causal).float()
            ref = FA.flash_attention_plain(q, k, v, causal=causal).float()
            share = float((out - ref).abs().max()) / (
                1e-2 * max(1.0, float(ref.abs().max())))
            worst = max(worst, share)
            print(f"  {(b, t, s, h, hkv, d, causal)} seed {seed}: share "
                  f"{share:.3f}")
    print(f"worst share {worst:.3f}")


if __name__ == "__main__":
    main()
