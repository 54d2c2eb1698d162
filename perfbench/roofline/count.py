"""The operations and bytes that a serving step's live work needs, from the
configuration alone (never from which kernel ran), and the analytic bound
of a step and of each kernel call.

A step's live work is its decoding rows (each with the number of keys it
attends over, its own included) and its prefill-chunk buckets (each a list
of ``(tokens already in the cache, chunk tokens)`` rows).  Padding, idle
batch rows and the trash page are no work.

Counted once each:
- a 4-bit weight: its codes at 0.5 B, one scale and one zero per group of
  ``G`` input rows per output column, at the model's dtype; per call for a
  kernel, once per step for the step (a step that launches prefill and
  decode apart still needs the weights once);
- a routed expert's weights, for the experts that the call's rows reach:
  ``E * (1 - (1 - k/E) ** rows)``, the expected count under uniform
  routing, since which experts a batch reaches depends on the data;
- the unquantized weights (router, head or tied embedding table), the
  embedding rows gathered, the logits written;
- the live KV rows read (the chunk's own keys come in as activations) and
  the new rows written, at the pools' dtype;
- each product's activations in and out, at the model's dtype (the
  activations', the pools' and the unquantized weights').

FLOPs are ``2 * rows * Ci * Co`` per product, ``4 * heads * head_dim`` per
query-key pair of attention, and ``2 * rows * d * vocab`` for the head.
The bound of a piece of work is ``max(FLOPs / peak FLOP/s, bytes / peak
B/s)`` with the peaks of ``peaks.json``.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import List, Sequence, Tuple

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


@dataclasses.dataclass
class Work:
    decode: List[int] = dataclasses.field(default_factory=list)
    chunks: List[List[Tuple[int, int]]] = dataclasses.field(
        default_factory=list)

    @property
    def rows(self) -> int:
        return len(self.decode) + sum(c for b in self.chunks for _, c in b)

    @property
    def head_rows(self) -> int:
        """Rows the head runs on: every decoding row and every chunk row
        (a chunk takes logits at each row's last token)."""
        return len(self.decode) + sum(len(b) for b in self.chunks)


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.flops + o.flops, self.bytes + o.bytes)

    def scaled(self, n: float) -> "Cost":
        return Cost(self.flops * n, self.bytes * n)

    def bound_s(self, peaks: dict = PEAKS) -> float:
        return max(self.flops / peaks["flops_per_s"],
                   self.bytes / peaks["bytes_per_s"])


def family(m: dict):
    """The op list of the model's family: ``roofline/<family>.py``."""
    return importlib.import_module(f"perfbench.roofline.{m['family']}")


def _itemsize(m: dict) -> int:
    return 2 if m.get("dtype", "bfloat16") == "bfloat16" else 4


def w4_bytes(m: dict, g: int, ci: int, co: int) -> float:
    return ci * co / 2 + 2 * (ci // g) * co * _itemsize(m)


def live_experts(e: int, k: int, rows: int) -> float:
    return e * (1.0 - (1.0 - k / e) ** rows) if rows else 0.0


def _dims(m: dict):
    d, h, hkv = m["d_model"], m["num_heads"], m["num_kv_heads"]
    return d, h, hkv, m.get("head_dim") or d // h


def kv_row_bytes(m: dict) -> int:
    """K and V of one token in one layer's pool."""
    _, _, hkv, dh = _dims(m)
    return 2 * hkv * dh * _itemsize(m)


def _call_rows(work: Work) -> List[int]:
    """Rows of each call of a projection: one per bucket, one decode."""
    rows = [sum(c for _, c in b) for b in work.chunks]
    return rows + ([len(work.decode)] if work.decode else [])


def w4_calls(config: dict, work: Work) -> List[Tuple[Cost, int]]:
    """``(cost, calls)`` of the 4-bit GEMMs (dense projections and routed
    experts) of the step, each call with its own weight bytes."""
    m, g = config["model"], int(config["quant"]["group_size"])
    fam, layers, act = family(m), m["num_layers"], _itemsize(m)
    e, k, experts = fam.expert_linears(m)
    out = []
    for r in _call_rows(work):
        for _, ci, co in fam.w4_linears(m):
            out.append((Cost(2.0 * r * ci * co,
                             w4_bytes(m, g, ci, co) + r * (ci + co) * act),
                        layers))
        for _, ci, co in experts:
            n = r * k
            out.append((Cost(2.0 * n * ci * co,
                             live_experts(e, k, r) * w4_bytes(m, g, ci, co)
                             + n * (ci + co) * act), layers))
    return out


def attn_calls(config: dict, work: Work) -> List[Tuple[Cost, int]]:
    """``(cost, calls)`` of the paged attention: one decode call and one
    call per prefill bucket in every layer."""
    m = config["model"]
    _, h, hkv, dh = _dims(m)
    kvb, layers, act = kv_row_bytes(m), m["num_layers"], _itemsize(m)
    out = []
    if work.decode:
        keys = sum(work.decode)
        out.append((Cost(4.0 * h * dh * keys,
                         keys * kvb + 2 * len(work.decode) * h * dh * act),
                    layers))
    for b in work.chunks:
        fl = by = 0.0
        for s, c in b:
            fl += 4.0 * h * dh * (c * s + c * (c + 1) / 2)
            by += s * kvb + c * 2 * hkv * dh * act + 2 * c * h * dh * act
        out.append((Cost(fl, by), layers))
    return out


def calls_bound_s(calls: Sequence[Tuple[Cost, int]]) -> float:
    return sum(c.bound_s() * n for c, n in calls)


def step_cost(config: dict, work: Work) -> Cost:
    """The whole step: every product's FLOPs; every weight once, the
    activations of every call, KV read and written, embedding rows, head."""
    m, g = config["model"], int(config["quant"]["group_size"])
    fam, layers = family(m), m["num_layers"]
    d, v, isz = m["d_model"], m["vocab_size"], _itemsize(m)
    rows, hrows = work.rows, work.head_rows
    if rows == 0:
        return Cost()
    total = Cost()
    for c, n in w4_calls(config, work) + attn_calls(config, work):
        total = total + c.scaled(n)
    # the per-call weight bytes are replaced by the weights once a step
    e, k, experts = fam.expert_linears(m)
    per_call_w = sum(w4_bytes(m, g, ci, co) for _, ci, co in fam.w4_linears(m))
    calls = len(_call_rows(work))
    expert_w = sum(w4_bytes(m, g, ci, co) for _, ci, co in experts)
    called_experts = sum(live_experts(e, k, r) for r in _call_rows(work)) \
        if experts else 0.0
    total.bytes -= layers * (calls * per_call_w + called_experts * expert_w)
    total.bytes += layers * (per_call_w
                             + (live_experts(e, k, rows) * expert_w
                                if experts else 0.0))
    for _, ci, co in fam.fp_linears(m):
        total = total + Cost(2.0 * rows * ci * co,
                             ci * co * isz + rows * (ci + co) * isz
                             ).scaled(layers)
    total.bytes += layers * rows * kv_row_bytes(m)          # KV written
    total.bytes += rows * d * isz                            # embedding rows
    total = total + Cost(2.0 * hrows * d * v,
                         d * v * isz + hrows * (d + v) * isz)
    return total
