"""Plain PyTorch reference of the benchmark's decoder configurations.

It reads a configuration file's ``model`` section (the port's field names)
and nothing of the program: the shapes of each group of weights are worked
out here, the seeded f32 weights come from ``harness.weights``, and the
4-bit RTN round trip is ``reference.rtn``'s own.  The forward pass is the
full causal forward of one sequence at a time, layer by layer across the
sequences, so only one layer's weights are alive at once:

- embedding rows; per block: norm, q/k/v projections (+ biases), standard
  RoPE on both halves of the head, causal softmax attention with grouped
  K/V heads at scale ``head_dim ** -0.5``, output projection, residual;
  norm, then the family's feed-forward part, ``reference/<family>.py``
  (``mlp_shapes(m)``, ``mlp(m, w, x, pr)``); residual;
- final norm and the f32 head (the embedding table when tied).

Norms run with eps 1e-5: LayerNorm with scale and bias, or RMSNorm.  Every
product is float32 with TF32 off, unless ``precision="tf32"``: the control,
which runs the same products in TF32 (on a card by cuBLAS's TF32 mode, on
the CPU by rounding both operands to TF32 first).
"""
from __future__ import annotations

import contextlib
import importlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench.harness.weights import make_group
from perfbench.reference.rtn import fake_quant

EPS = 1e-5


def _hdim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def _norm_shapes(m: dict, name: str) -> Dict[str, Tuple[int, ...]]:
    d = m["d_model"]
    out = {f"{name}.scale": (d,)}
    if m.get("norm", "rmsnorm") == "layernorm":
        out[f"{name}.bias"] = (d,)
    return out


def family(m: dict):
    """The feed-forward part of the model's family:
    ``reference/<family>.py``."""
    return importlib.import_module(f"perfbench.reference.{m['family']}")


def linear_shapes(name: str, ci: int, co: int, bias: bool):
    out = {f"{name}.w": (ci, co)}
    if bias:
        out[f"{name}.b"] = (co,)
    return out


def layer_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    """``{dotted path: shape}`` of one decoder block."""
    d, h, hkv, dh = m["d_model"], m["num_heads"], m["num_kv_heads"], _hdim(m)
    b = bool(m.get("attn_bias", False))
    s = {**_norm_shapes(m, "norm1"), **_norm_shapes(m, "norm2")}
    s.update(linear_shapes("mixer.wq", d, h * dh, b))
    s.update(linear_shapes("mixer.wk", d, hkv * dh, b))
    s.update(linear_shapes("mixer.wv", d, hkv * dh, b))
    s.update(linear_shapes("mixer.wo", h * dh, d, b))
    s.update(family(m).mlp_shapes(m))
    return s


def embed_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    return {"embed.table": (m["vocab_size"], m["d_model"])}


def head_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    s = _norm_shapes(m, "final_norm")
    if not m.get("tie_embeddings", False):
        s["lm_head.w"] = (m["d_model"], m["vocab_size"])
    return s


def quantized_leaves(m: dict) -> List[str]:
    """The leaves served as 4-bit codes: every projection weight of a
    block but the router's."""
    return [p for p in layer_shapes(m)
            if p.startswith(("mixer.", "mlp.")) and not p.endswith(".b")
            and not p.startswith("mlp.router")]


# ------------------------------------------------------------- precision --
def _to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, nearest, ties to even)."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class _Prec:
    def __init__(self, precision: str, device: torch.device):
        if precision not in ("f32", "tf32"):
            raise ValueError(f"precision {precision!r}: 'f32' or 'tf32'")
        self.emulate = precision == "tf32" and device.type != "cuda"
        self.precision = precision
        self.device = device

    @contextlib.contextmanager
    def scope(self):
        mm = torch.backends.cuda.matmul
        old = (mm.allow_tf32, torch.backends.cudnn.allow_tf32)
        mm.allow_tf32 = torch.backends.cudnn.allow_tf32 = (
            self.precision == "tf32" and self.device.type == "cuda")
        try:
            yield self
        finally:
            mm.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.emulate:
            a, b = _to_tf32(a), _to_tf32(b)
        return torch.matmul(a, b)


# --------------------------------------------------------------- layers ---
def _norm(w: Dict[str, torch.Tensor], name: str, x: torch.Tensor):
    scale = w[f"{name}.scale"]
    if f"{name}.bias" in w:
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + EPS) * scale + w[f"{name}.bias"]
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * scale


def lin(w, name: str, x, pr: _Prec):
    y = pr.mm(x, w[f"{name}.w"])
    b = w.get(f"{name}.b")
    return y if b is None else y + b


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x[T, H, Dh] at positions 0..T-1, the two halves rotated."""
    t, _, dh = x.shape
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32),
                          torch.arange(0, dh, 2, dtype=torch.float32) / dh)
    ang = (torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
           * inv.to(x.device))[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(m, w, x, pr: _Prec):
    t = x.shape[0]
    h, hkv, dh = m["num_heads"], m["num_kv_heads"], _hdim(m)
    theta = float(m.get("rope_theta", 1e4))
    q = _rope(lin(w, "mixer.wq", x, pr).view(t, h, dh), theta)
    k = _rope(lin(w, "mixer.wk", x, pr).view(t, hkv, dh), theta)
    v = lin(w, "mixer.wv", x, pr).view(t, hkv, dh)
    grp = h // hkv
    k = k.repeat_interleave(grp, dim=1).transpose(0, 1)      # [H, T, Dh]
    v = v.repeat_interleave(grp, dim=1).transpose(0, 1)
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    out = torch.empty(t, h, dh, device=x.device)
    for h0 in range(0, h, 8):                                # bound memory
        qh = q[:, h0:h0 + 8].transpose(0, 1)
        s = pr.mm(qh, k[h0:h0 + 8].transpose(1, 2)) * dh ** -0.5
        s = torch.where(mask, s, torch.full_like(s, -math.inf))
        p = torch.softmax(s, dim=-1)
        out[:, h0:h0 + 8] = pr.mm(p, v[h0:h0 + 8]).transpose(0, 1)
    return lin(w, "mixer.wo", out.reshape(t, h * dh), pr)


def _block(m, w, x, pr: _Prec):
    x = x + _attention(m, w, _norm(w, "norm1", x), pr)
    return x + family(m).mlp(m, w, _norm(w, "norm2", x), pr)


# -------------------------------------------------------------- forward ---
def logits_at(config: dict, seed: int, seqs: Sequence[np.ndarray],
              picks: Sequence[np.ndarray], device, *,
              precision: str = "f32") -> List[torch.Tensor]:
    """The logits ``[len(pick), V]`` (f32) of each token sequence at its
    positions ``pick``, from the full causal forward of the sequence over
    the seeded weights of ``config``, round-tripped through 4-bit RTN at
    the configuration's group size."""
    m = config["model"]
    g = int(config["quant"]["group_size"])
    device = torch.device(device)
    pr = _Prec(precision, device)
    qleaves = set(quantized_leaves(m))
    with torch.no_grad(), pr.scope():
        emb = make_group(seed, "embed", embed_shapes(m), device)
        xs = [emb["embed.table"][torch.as_tensor(np.asarray(s, np.int64),
                                                 device=device)]
              for s in seqs]
        if not m.get("tie_embeddings", False):
            del emb
        for i in range(m["num_layers"]):
            w = make_group(seed, f"layers.{i}", layer_shapes(m), device)
            for p in qleaves:
                w[p] = fake_quant(w[p], g)
            xs = [_block(m, w, x, pr) for x in xs]
            del w
        head = make_group(seed, "head", head_shapes(m), device)
        wout = (emb["embed.table"].T if m.get("tie_embeddings", False)
                else head["lm_head.w"])
        out = []
        for x, pick in zip(xs, picks):
            sel = x[torch.as_tensor(np.asarray(pick, np.int64),
                                    device=device)]
            out.append(pr.mm(_norm(head, "final_norm", sel), wout))
        return out
