"""Deterministic, resumable synthetic token pipeline (port of
``repro/data/pipeline.py``).

Every batch is a pure function of (seed, step): resuming is setting the
step counter, with no iterator state to save.  Tokens (and an
encoder-decoder's frames) come from the reference's numpy generators,
``(seed << 32) ^ step`` (``^ 0xF00D`` for the frames), so a batch is the
reference's bit for bit.  The stream is a Zipf mixture with a token copied
every ``copy_period`` positions from ``copy_period // 2`` earlier, a
learnable signal under which a small model's loss falls.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    zipf_a: float = 1.2
    copy_period: int = 64          # long-range structure for learnability


class SyntheticTokens:
    """Stateless batch source: ``batch_at(step)`` for any step, any time,
    as tensors on ``device``."""

    def __init__(self, dc: DataConfig, cfg: Optional[ModelConfig] = None, *,
                 device="cuda"):
        self.dc = dc
        self.cfg = cfg
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        dc = self.dc
        rng = np.random.default_rng((dc.seed << 32) ^ step)
        ranks = rng.zipf(dc.zipf_a, size=(dc.global_batch, dc.seq_len + 1))
        toks = (ranks % (dc.vocab_size - 2) + 2).astype(np.int32)
        p = dc.copy_period
        idx = np.arange(dc.seq_len + 1)
        src = idx - p // 2
        mask = (idx % p == 0) & (src >= 0)
        toks[:, mask] = toks[:, src[mask]]
        batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                 "labels": torch.from_numpy(toks[:, 1:].copy())}
        if self.cfg is not None and self.cfg.encdec:
            frng = np.random.default_rng((dc.seed << 32) ^ step ^ 0xF00D)
            batch["frames"] = torch.from_numpy(frng.standard_normal(
                (dc.global_batch, dc.seq_len, self.cfg.d_model),
                np.float32)).to(self.cfg.tdtype)
        return {k: v.to(self.device) for k, v in batch.items()}

    def iterate(self, start_step: int = 0
                ) -> Iterator[Dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1
