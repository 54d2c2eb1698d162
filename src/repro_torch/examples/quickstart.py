"""Quickstart: SmoothQuant+ 4-bit PTQ of a small Code Llama-style model
(port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. init an fp model, 2. calibrate, search α, smooth and int4-quantize,
3. compare the quantized outputs with the fp ones, 4. generate a few tokens
W4A16 through the contiguous decode cache.  On the card every quantized
linear runs the W4A16 kernel.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core.apply import smoothquant_plus
from repro_torch.core.calibration import synthetic_calibration_set
from repro_torch.device import resolve_device
from repro_torch.models import api


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--new-tokens", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("codellama-7b", smoke=True).with_(dtype="float32")
    params = api.init_model(cfg, seed=0, device=dev)
    print(f"model: {cfg.name}  params: "
          f"{sum(t.numel() for t in T.leaves(params)):,}")
    fp = T.map_leaves(torch.clone, params)    # PTQ works in place

    calib = synthetic_calibration_set(cfg, n_seqs=4, seq_len=32)
    qparams, report = smoothquant_plus(params, cfg, calib,
                                       QuantConfig(group_size=16), step=0.25,
                                       verbose=True)
    print(f"searched alpha={report.alpha:.2f}  "
          f"whole-model loss={report.search_loss:.5f}")
    print(f"linear weights: {report.fp_bytes / 1e6:.2f} MB fp16-equiv -> "
          f"{report.quant_bytes / 1e6:.2f} MB int4 "
          f"({report.quant_bytes / report.fp_bytes:.0%})")

    batch = {k: v.to(dev) for k, v in calib[0].items()}
    with torch.no_grad():
        lf = api.forward_fn(fp, batch, cfg)
        lq = api.forward_fn(qparams, batch, cfg)
        rel = float(torch.linalg.norm(lq - lf) / torch.linalg.norm(lf))
        print(f"relative logit error after PTQ: {rel:.4f}")

        prompt = torch.tensor([[5, 17, 300, 42]], dtype=torch.int32,
                              device=dev)
        logits, cache = api.prefill_fn(qparams, {"tokens": prompt}, cfg, 32)
        toks = [int(logits.argmax(-1)[0])]
        pos = prompt.shape[1]
        for _ in range(args.new_tokens):
            logits, cache = api.decode_fn(
                qparams, {"token": torch.tensor([[toks[-1]]],
                                                dtype=torch.int32,
                                                device=dev),
                          "position": torch.tensor([pos], dtype=torch.int32,
                                                   device=dev)},
                cache, cfg)
            toks.append(int(logits.argmax(-1)[0]))
            pos += 1
    print("generated (W4A16):", toks)
    return {"alpha": report.alpha, "rel_logit_err": rel, "tokens": toks,
            "fp_bytes": report.fp_bytes, "quant_bytes": report.quant_bytes}


if __name__ == "__main__":
    main()
