"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed, a sample of the requests that finished in it
is drawn from the seed, the longest (prompt plus output) always among them.
The reference runs once over each prompt followed by its served tokens and
gives its logits at every position where a token was served: the prompt's
last (the first token) and each decode step's.  Two kinds of number are
compared (:func:`compare`): the served tokens' gap below the reference's
best, and the error of the program's own best logit, captured as it
sampled.
Greedy decoding gives a gap of 0 up to near-ties, which rounding may flip.
Which of the numbers a cell is held to, and their limits, its
configuration's ``correct`` says.

The control puts the reference in the program's place at the next lower
precision (TF32 products for a float32 configuration) and reads, at each of
the same positions, the same two numbers for the token the lower precision
puts first.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench.harness.stats import Rec
from perfbench.reference.model import logits_at

Seqs = Dict[int, Tuple[np.ndarray, np.ndarray]]      # uid -> (prompt, out)


def sample(recs: Sequence[Rec], t0: float, t1: float, seed: int,
           k: int) -> List[int]:
    """uids of up to ``k`` requests that finished in ``[t0, t1]``: the
    longest, then others drawn from the seed."""
    done = [r for r in recs if r.finish == "length" and r.done_t is not None
            and t0 <= r.done_t <= t1]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.prompt_len + r.n_out, -r.uid))
    rest = [r.uid for r in done if r.uid != longest.uid]
    rng = np.random.default_rng([int(seed), 0xC4EC])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) \
        if rest and k > 1 else []
    return sorted([longest.uid] + [rest[i] for i in pick])


def _inputs(seqs: Seqs):
    toks, picks = [], []
    for prompt, out in seqs.values():
        toks.append(np.concatenate([prompt, out[:-1]]).astype(np.int64))
        picks.append(np.arange(len(prompt) - 1, len(prompt) - 1 + len(out)))
    return toks, picks


def compare(config: dict, seed: int, seqs: Seqs, best: Dict[int, dict],
            device, *, control: bool = False) -> Dict[str, float]:
    """The numbers compared, in units of the reference logits' standard
    deviation at each served position:

    - ``gap``: the widest by which a served token's logit lies below the
      reference's best;
    - ``logit_err``: the widest by which the program's best logit
      (``best``, captured at sampling) lies from the reference's logit of
      the served token;
    - ``logit_err_req_p90``: the largest over the sampled requests of each
      request's 90th percentile of that error, so that a fault confined to
      one request, or to a tenth of its positions, still shows;
    - ``logit_err_mid``: the median over the requests of the same, for a
      model whose top-k routing has near-ties: rounding flips one and the
      rest of that one request departs, which the median leaves aside.

    With ``control``, also each of them prefixed ``control_``: the same
    for the TF32 reference in the program's place (the token it puts
    first, its own best logit)."""
    toks, picks = _inputs(seqs)
    ref = logits_at(config, seed, toks, picks, device)
    ctl = (logits_at(config, seed, toks, picks, device, precision="tf32")
           if control else [None] * len(ref))
    acc: Dict[str, List[torch.Tensor]] = {}
    for (uid, (_, out)), l, c in zip(seqs.items(), ref, ctl):
        std = l.std(dim=-1)
        top = l.max(dim=-1).values
        o = torch.as_tensor(out, device=l.device)
        mine = l.gather(-1, o[:, None])[:, 0]
        got = torch.tensor([best[uid][k] for k in range(len(out))],
                           dtype=l.dtype, device=l.device)
        acc.setdefault("gap", []).append((top - mine) / std)
        acc.setdefault("logit_err", []).append((got - mine).abs() / std)
        if c is not None:
            pick = c.argmax(dim=-1)
            theirs = l.gather(-1, pick[:, None])[:, 0]
            acc.setdefault("control_gap", []).append((top - theirs) / std)
            acc.setdefault("control_logit_err", []).append(
                (c.max(dim=-1).values - theirs).abs() / std)
    out = {}
    for k, v in acc.items():
        out[k] = float(torch.cat(v).max())
        if "logit_err" in k:
            p90 = [float(torch.quantile(x.double(), 0.9)) for x in v]
            out[k + "_req_p90"] = max(p90)
            out[k + "_mid"] = statistics.median(p90)
    return out
