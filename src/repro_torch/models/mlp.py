"""Channel mixers: the dense SwiGLU or GELU MLP and the sort-based top-k
MoE (port of ``repro/models/mlp.py``).  The GELU MLP (StarCoder2) is
``{up, down}``, with biases under ``cfg.attn_bias``.

The MoE uses the reference's equal-capacity sort-based dispatch: token
slots are sorted by assigned expert (stable, so ties keep row order),
sliced into an ``[E, C, D]`` buffer (overflow dropped), run through the
stacked expert weights with one grouped product per weight, and combined
back with the router weights; DeepSeek-V2's shared experts are one dense
SwiGLU (``d_ff = d_expert · num_shared``) added for every token.  After PTQ the stacked ``[E, Ci, Co]``
weights are int4 :class:`QuantizedTensor` s and contract through
``kernels.ops.w4a16_grouped_matmul`` (B6, or B7 under A8).  With a hint
mesh installed (``sharding/hints.py``), tokens are dispatched in ``nblk =
data · pod`` blocks, as in the reference: each block fills its own capacity
slice of every expert, so the sort stays local to a data shard, and the
``[nblk, E, C, D]`` buffer is hinted to (data, model).  With no mesh it is
the one-block case.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import calibration as _calib
from repro_torch.core.quantize import QuantizedTensor, a8_roundtrip_error
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import layers as L
from repro_torch.serving.trace import span
from repro_torch.sharding import hints as H


# ------------------------------------------------------------- dense MLP ----
def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Dict[str, Any]:
    d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.tdtype
    if cfg.mlp == "swiglu":
        return {"gate": L.init_linear(gen, d, f, dt),
                "up": L.init_linear(gen, d, f, dt),
                "down": L.init_linear(gen, f, d, dt)}
    b = cfg.attn_bias
    return {"up": L.init_linear(gen, d, f, dt, bias=b),
            "down": L.init_linear(gen, f, d, dt, bias=b)}


def apply_mlp(p: Dict[str, Any], x: torch.Tensor, *, act: str = "a16"
              ) -> torch.Tensor:
    if "gate" in p:
        h = L.swiglu(L.apply_linear(p["gate"], x, act=act),
                     L.apply_linear(p["up"], x, act=act))
    else:
        h = L.gelu(L.apply_linear(p["up"], x, act=act))
    return L.apply_linear(p["down"], h, act=act)


# ------------------------------------------------------------------- MoE ----
def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    m = cfg.moe
    d, fe, dt = cfg.d_model, m.d_expert, cfg.tdtype
    p = {
        "router": L.init_linear(gen, d, m.num_experts, dt),
        # stacked expert weights [E, D, F] / [E, F, D] (swiglu experts)
        "experts": {
            "gate": L._randn(gen, (m.num_experts, d, fe), d ** -0.5, dt),
            "up": L._randn(gen, (m.num_experts, d, fe), d ** -0.5, dt),
            "down": L._randn(gen, (m.num_experts, fe, d), fe ** -0.5, dt),
        },
    }
    if m.num_shared_experts:
        # the shared experts as one dense SwiGLU every token goes through
        p["shared"] = init_mlp(gen, cfg, d_ff=fe * m.num_shared_experts)
    return p


def moe_capacity(n: int, m: MoEConfig) -> int:
    """Rows per expert for a call over ``n`` tokens (pad rows included)."""
    return max(int(n * m.top_k / m.num_experts * m.capacity_factor), m.top_k)


def _expert_matmul(x: torch.Tensor, w, *, act: str = "a16",
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-expert contraction ``x[nblk, E, C, D] @ w[E, D, F] → [nblk, E, C,
    F]`` in f32: a stacked fp tensor, or after PTQ a stacked int4
    QuantizedTensor through the grouped kernel (never dequantized
    model-side), the blocks riding each expert's rows.  ``rows`` (int32[E],
    one block only) is each expert's filled rows; the rows past them are
    zero."""
    nblk, e, c, d = x.shape
    xe = x.permute(1, 0, 2, 3).reshape(e, nblk * c, d)
    if isinstance(w, QuantizedTensor):
        y = kops.w4a16_grouped_matmul(xe.to(torch.float32).contiguous(), w,
                                      act=act, rows=rows)
    else:
        y = torch.bmm(xe.to(torch.float32), w.to(torch.float32))
    return y.reshape(e, nblk, c, -1).permute(1, 0, 2, 3)


def dispatch_blocks(n: int) -> int:
    """Token blocks of the MoE dispatch: ``data · pod`` of the installed
    hint mesh when it divides the ``n`` tokens, else 1."""
    mesh = H.current_mesh()
    if mesh is None or os.environ.get("REPRO_NO_HINTS"):
        return 1
    sizes = axis_sizes(mesh)
    nblk = sizes.get("data", 1) * sizes.get("pod", 1)
    return nblk if n % nblk == 0 else 1


def _dispatch_indices(expert_ids: torch.Tensor, num_experts: int,
                      capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based dispatch bookkeeping.

    expert_ids: [N] (token slot → expert).  Returns (buf_idx [N], keep [N]
    bool, counts [E]): token slot i goes to flat buffer row ``buf_idx[i]``
    (= expert · capacity + position) iff ``keep[i]``; ``counts[e]`` slots
    chose expert e (before the capacity drop), so its filled rows are the
    prefix ``min(counts[e], capacity)``.
    """
    n = expert_ids.shape[0]
    ids = expert_ids.long()
    sort_idx = torch.argsort(ids, stable=True)
    sorted_ids = ids[sort_idx]
    # index_add_, not bincount: on the card bincount reads max(ids) back to
    # the host
    counts = torch.zeros(num_experts, dtype=torch.long,
                         device=ids.device).index_add_(
                             0, ids, torch.ones_like(ids))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_expert = torch.arange(n, device=ids.device) - starts[sorted_ids]
    keep_sorted = pos_in_expert < capacity
    buf_sorted = sorted_ids * capacity + torch.clamp(pos_in_expert,
                                                     max=capacity - 1)
    # write back through the permutation (a scatter, not a second sort)
    buf_idx = torch.empty_like(buf_sorted)
    buf_idx[sort_idx] = buf_sorted
    keep = torch.empty_like(keep_sorted)
    keep[sort_idx] = keep_sorted
    return buf_idx, keep, counts


def apply_moe(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x[B, T, D] → (y[B, T, D], aux): aux is the Switch-style
    load-balancing loss."""
    m = cfg.moe
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    with span("model.moe.dispatch"):    # router to the rows before B6
        router_logits = L.apply_linear(p["router"], xf).to(torch.float32)
        probs = torch.softmax(router_logits, dim=-1)            # [N, E]
        # top-k with lower expert index first on ties, like lax.top_k
        gate_w, gate_e = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
        gate_w, gate_e = gate_w[:, :m.top_k], gate_e[:, :m.top_k]
        gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)

        # blocked dispatch: block b's slots sort among "virtual experts"
        # b·E + e, which is the reference's per-block dispatch in one sort
        nblk = dispatch_blocks(n)
        n_loc = n // nblk
        capacity = moe_capacity(n_loc, m)
        flat_e = gate_e.reshape(-1)                             # [N·K]
        blk = torch.arange(n * m.top_k, device=x.device) \
            // (n_loc * m.top_k)
        buf_idx, keep, counts = _dispatch_indices(
            flat_e + blk * m.num_experts, nblk * m.num_experts, capacity)
        rows = (torch.clamp(counts, max=capacity).to(torch.int32)
                if nblk == 1 else None)
        # scatter only the slot → token map, then gather the rows
        n_slots = nblk * m.num_experts * capacity
        slot_tok = torch.full((n_slots + 1,), -1, dtype=torch.long,
                              device=x.device)
        tok_of_src = torch.arange(n * m.top_k, device=x.device) // m.top_k
        slot_tok[torch.where(keep, buf_idx, n_slots)] = tok_of_src
        slot_tok = slot_tok[:n_slots]
        buf = xf[torch.clamp_min(slot_tok, 0)]
        buf = torch.where((slot_tok >= 0)[:, None], buf,
                          torch.zeros_like(buf))
        buf = buf.reshape(nblk, m.num_experts, capacity, d)
    buf = H.shard_hint(buf, ("pod", "data"), "model", None, None)

    act = cfg.act_kernel
    ew = p["experts"]
    gate_h = _expert_matmul(buf, ew["gate"], act=act, rows=rows)
    up_h = _expert_matmul(buf, ew["up"], act=act, rows=rows)
    hidden = F.silu(gate_h) * up_h
    col = _calib.current_collector()
    if col is not None:   # per-expert input stats (no apply_linear here)
        col.record_explicit(("mlp", "experts", "gate"),
                            buf.to(torch.float32).abs().amax(dim=(0, 2)),
                            a8_err=a8_roundtrip_error(buf))
        col.record_explicit(("mlp", "experts", "down"),
                            hidden.abs().amax(dim=(0, 2)),
                            a8_err=a8_roundtrip_error(hidden))
    out = _expert_matmul(hidden, ew["down"], act=act, rows=rows).to(x.dtype)

    gathered = out.reshape(n_slots, d)[buf_idx]                 # [N·K, D]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros_like(gathered))
    weighted = gathered.to(torch.float32) * gate_w.reshape(-1)[:, None]
    y = weighted.reshape(n, m.top_k, d).sum(1).to(x.dtype)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], xf, act=act)

    me = probs.mean(0)
    ce = torch.zeros(m.num_experts, device=x.device).index_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) \
        / max(n * m.top_k, 1)
    aux = m.num_experts * torch.sum(me * ce)
    return y.reshape(b, t, d), aux
