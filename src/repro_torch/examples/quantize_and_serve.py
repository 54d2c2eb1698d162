"""End to end (the paper's deployment story; port of
``examples/quantize_and_serve.py``): quantize on load with SmoothQuant+,
save the PTQ artifact and boot again from it, then serve batched requests
with continuous batching over the paged KV cache and report throughput,
TTFT and latency against the fp engine (the offline analog of paper Fig.
7).

    PYTHONPATH=src python -m repro_torch.examples.quantize_and_serve \\
        [--device cpu] [--requests 10] [--max-tokens 8]

The artifact goes to a fresh temporary directory (``--artifact`` names
another).
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core.calibration import synthetic_calibration_set
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving.engine import (Request, ServingEngine,
                                        load_or_quantize)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--artifact", default=None,
                    help="PTQ artifact directory (default: a fresh "
                         "temporary one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("codellama-7b", smoke=True).with_(dtype="float32")
    params = api.init_model(cfg, seed=0, device=dev)
    fp = T.map_leaves(torch.clone, params)    # PTQ works in place
    calib = synthetic_calibration_set(cfg, n_seqs=2, seq_len=24)
    artifact = args.artifact or tempfile.mkdtemp() + "/ptq"
    qcfg = QuantConfig(group_size=16)
    t0 = time.perf_counter()
    qparams, report = load_or_quantize(params, cfg, calib, qcfg,
                                       artifact_dir=artifact, device=dev)
    t_quant = time.perf_counter() - t0
    t0 = time.perf_counter()                # ... serve many: artifact boot
    qparams, _ = load_or_quantize(None, cfg, None, qcfg,
                                  artifact_dir=artifact, device=dev)
    print(f"quantized (alpha={report.alpha:.2f}) in {t_quant:.2f}s; "
          f"artifact re-boot in {time.perf_counter() - t0:.2f}s; "
          "serving...")

    rng = np.random.default_rng(0)
    out = {"alpha": report.alpha}
    for tag, p in (("fp", fp), ("w4a16", qparams)):
        eng = ServingEngine(p, cfg, batch_size=4, max_seq=64, page_size=16,
                            device=dev)
        reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab_size, 10)
                        .astype(np.int32), max_tokens=args.max_tokens)
                for i in range(args.requests)]
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_drained()
        dt = time.perf_counter() - t0
        lat = np.mean([(r.done_t - r.first_token_t)
                       / max(len(r.output) - 1, 1)
                       for r in reqs if r.done_t and r.first_token_t]) * 1e3
        ttft = np.mean([r.first_token_t - r.arrival_t for r in reqs]) * 1e3
        print(f"[{tag:6s}] {stats.completed} reqs, {stats.decoded_tokens} "
              f"tokens in {dt:.2f}s -> {stats.decoded_tokens / dt:.1f} tok/s,"
              f" ttft {ttft:.1f} ms, {lat:.1f} ms/token "
              f"({stats.prefill_batches} joint prefills)")
        out[tag] = {"completed": stats.completed,
                    "decoded_tokens": stats.decoded_tokens,
                    "outputs": [r.output for r in reqs]}
    return out


if __name__ == "__main__":
    main()
