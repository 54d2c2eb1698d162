"""Token sampling for the serving engine (port of
``repro/serving/sampling.py``): greedy, temperature, and the top-k /
nucleus-p masks, drawing from an explicit ``torch.Generator``."""
from __future__ import annotations

import torch

from repro_torch.serving.trace import ENCLOSING, span

NEG = -1e30


def filter_top_k_top_p(logits: torch.Tensor, top_k, top_p) -> torch.Tensor:
    """Mask logits outside the top-k / nucleus-p set with -1e30.  ``top_k``
    / ``top_p`` are scalars or per-row ``[B]``; ``0`` / ``1.0`` disable the
    filter for that row.  Top-p runs over the top-k-masked distribution."""
    if isinstance(top_k, int) and top_k == 0 \
            and isinstance(top_p, (int, float)) and top_p >= 1.0:
        return logits
    b, v = logits.shape
    dev = logits.device
    top_k = torch.as_tensor(top_k, dtype=torch.long, device=dev).expand(b)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(b)
    k = top_k.clamp(0, v)
    srt = torch.sort(logits, dim=-1, descending=True).values
    kth = srt.gather(1, (k.clamp_min(1) - 1)[:, None])
    logits = torch.where((k[:, None] > 0) & (logits < kth),
                         torch.full_like(logits, NEG), logits)
    srt = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
    cutoff_idx = torch.clamp((cum < top_p[:, None]).sum(dim=-1), max=v - 1)
    cutoff = srt.gather(1, cutoff_idx[:, None])
    return torch.where((top_p[:, None] < 1.0) & (logits < cutoff),
                       torch.full_like(logits, NEG), logits)


def sample_per_slot(logits: torch.Tensor, gen: torch.Generator,
                    temperatures: torch.Tensor, top_k=0, top_p=1.0
                    ) -> torch.Tensor:
    """Row ``b`` is argmax when ``temperatures[b] <= 0``, else a draw at its
    own temperature from its own top-k / top-p filtered distribution."""
    greedy = logits.argmax(dim=-1)
    stoch_rows = temperatures > 0
    with span("sync.sample.any", ENCLOSING):   # reads the flag back
        stoch = bool(stoch_rows.any())
    if not stoch:
        return greedy
    t = torch.where(stoch_rows, temperatures, torch.ones_like(temperatures))
    scaled = filter_top_k_top_p(logits.to(torch.float32) / t[:, None],
                                top_k, top_p)
    stoch = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                              generator=gen)[:, 0]
    return torch.where(stoch_rows, stoch, greedy)
