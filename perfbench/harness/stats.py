"""Exact tails from the requests' own timestamps.

Every time is a reading of ``time.perf_counter`` in the one benchmark
process: the engine stamps ``first_token_t`` and ``done_t`` with it, and the
loop stamps each request's due and submit times.

- A percentile is the nearest rank: the ``ceil(q * n)``-th smallest of the
  ``n`` values, one of them, never a bucket's bound.
- TPOT of a request: (last token - first token) / (tokens - 1), over the
  tokens it had when the window closed; a request still decoding then
  counts up to the window's end.  Requests with fewer than two tokens by
  then have none.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Sequence

TERMINAL_BAD = ("failed", "rejected", "deadline", "cancelled")


@dataclasses.dataclass
class Rec:
    """What the benchmark knows of one request once the window closed."""
    uid: int
    prompt_len: int
    max_tokens: int
    due: float
    submit_t: float
    first_t: Optional[float] = None
    done_t: Optional[float] = None
    n_out: int = 0                 # tokens emitted when the window closed
    finish: Optional[str] = None


def percentile(values: Sequence[float], q: float) -> float:
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    return v[max(math.ceil(q * len(v)) - 1, 0)]


def tpot(r: Rec, t_end: float) -> Optional[float]:
    if r.first_t is None or r.first_t > t_end or r.n_out < 2:
        return None
    last = r.done_t if r.done_t is not None and r.done_t <= t_end else t_end
    return (last - r.first_t) / (r.n_out - 1)


def tpots(recs: Iterable[Rec], t_end: float) -> List[float]:
    return [x for x in (tpot(r, t_end) for r in recs) if x is not None]
