"""The one traffic generator: a mix file's parameters and a seed give an
endless, repeatable stream of requests.

Sizes come in blocks of ``block`` requests.  Within a block, the prompt
lengths are the length distribution's quantiles at ``(i + 0.5) / block``
and so are the output lengths, paired by one fixed permutation, the same
for every seed.  The seed shuffles the order of the block's requests.  So
every seed serves the same sample of the mix's distributions in another
order, and runs with different seeds differ by the order alone.  Prompt
token ids are drawn uniformly from ``[2, vocab)``.

Mix keys read here: ``prompt_len`` and ``output_len``, each ``{"dist":
"lognormal", "median" or "mean", "sigma", "min", "max"}`` (a log-normal
distribution clipped to ``[min, max]``, inclusive), ``max_total`` (an
output is cut so that prompt plus output stays within it) and ``block``.
When requests fall due is the mix's loop's business (``loops/<loop>.py``):
the stream's requests carry no arrival time.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class Item:
    uid: int
    prompt: np.ndarray        # int32 token ids
    max_tokens: int


def quantiles(spec: dict, n: int) -> np.ndarray:
    """``n`` integer lengths at the mid-quantiles of ``spec``."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    sigma = float(spec["sigma"])
    median = (float(spec["median"]) if "median" in spec
              else float(spec["mean"]) * math.exp(-sigma * sigma / 2))
    z = [statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    x = median * np.exp(sigma * np.asarray(z))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


# the pairing of prompt and output quantiles, fixed for every seed
PAIRING_SEED = 0x9A1F


def block(mix: dict):
    """The block's ``(prompt lengths, output lengths)``, paired."""
    n = int(mix["block"])
    prompts = quantiles(mix["prompt_len"], n)
    outputs = quantiles(mix["output_len"], n)[
        np.random.default_rng(PAIRING_SEED).permutation(n)]
    if "max_total" in mix:
        outputs = np.minimum(outputs, int(mix["max_total"]) - prompts)
    return prompts, outputs


def stream(mix: dict, seed: int, vocab: int) -> Iterator[Item]:
    prompts, outputs = block(mix)
    rng = np.random.default_rng([int(seed), 0x5EED])
    uid = 0
    while True:
        for j in rng.permutation(len(prompts)):
            toks = rng.integers(2, vocab, size=int(prompts[j]),
                                dtype=np.int64)
            yield Item(uid, toks.astype(np.int32), int(outputs[j]))
            uid += 1
