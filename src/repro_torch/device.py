"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"`` and refuse to run anywhere else by
accident: with no card they raise instead of carrying on on the CPU.  Tests
and CPU tooling pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' explicitly to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def strict_fp32_matmul() -> None:
    """Full-f32 products for matmuls and convolutions (no TF32): the PTQ
    math and the kernels' plain versions compare at f32 precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
