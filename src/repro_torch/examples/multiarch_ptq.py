"""SmoothQuant+ across the architecture families at smoke scale, printing
each one's quantization report (port of ``examples/multiarch_ptq.py``):
dense, MoE, MLA, hybrid, RWKV and encoder-decoder models.

    PYTHONPATH=src python -m repro_torch.examples.multiarch_ptq \\
        [--device cpu] [--archs ID,ID,...]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core.apply import smoothquant_plus
from repro_torch.core.calibration import synthetic_calibration_set
from repro_torch.device import resolve_device
from repro_torch.models import api

# the reference example's architectures: the first ten of its registry, in
# its order (the port's ARCH_IDS lists them in another)
ARCHS = ("mistral-large-123b", "chatglm3-6b", "llama3.2-3b",
         "starcoder2-15b", "zamba2-7b", "qwen2-vl-7b",
         "granite-moe-1b-a400m", "deepseek-v2-236b", "rwkv6-7b",
         "whisper-medium")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--archs", default=",".join(ARCHS),
                    help="comma-separated architectures")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    reports = {}
    for arch in args.archs.split(","):
        cfg = get_config(arch, smoke=True).with_(dtype="float32")
        params = api.init_model(cfg, seed=0, device=dev)
        calib = synthetic_calibration_set(cfg, n_seqs=2, seq_len=24)
        _, rep = smoothquant_plus(params, cfg, calib,
                                  QuantConfig(group_size=16), step=0.5)
        print(f"{arch:24s} alpha={rep.alpha:.2f} "
              f"quantized={len(rep.quantized_paths):3d} weight groups  "
              f"{rep.fp_bytes / 1e6:7.2f}MB -> {rep.quant_bytes / 1e6:7.2f}MB")
        reports[arch] = rep
    return reports


if __name__ == "__main__":
    main()
