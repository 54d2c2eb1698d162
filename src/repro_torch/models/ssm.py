"""Sub-quadratic sequence mixers: Mamba2 (chunked SSD) and RWKV6 (Finch)
(port of ``repro/models/ssm.py``).

Mamba2 uses the chunked SSD algorithm: a quadratic, attention-like form
within length-L chunks and linear state passing between chunks, so a prefill
holds O(T·L) scores and only chunk-boundary states.  RWKV6 has the Finch
data-dependent per-channel decay ``w_t = exp(-exp(w0 + lora(x̃_t)))`` and a
sequential scan over time (per-step state ``[B, H, K, V]``); token-shift
mixing uses learned per-channel lerps, as in the reference.

The reference computes the convolutions, the SSD scan, the RWKV recurrence
and the decay LoRA as XLA ops outside any Pallas kernel, so they are plain
PyTorch ops here; every projection is a :func:`layers.apply_linear` with
``act=cfg.act_kernel``, which reaches the W4A16 kernel (K1) once quantized.
A Python loop over time stands in for the reference's ``lax.scan``.

States: Mamba2 ``{"h": [B, H, P, N] f32, "conv_x": [B, K-1, d_inner],
"conv_bc": [B, K-1, 2N]}``; RWKV6 ``{"wkv": [B, H, K, V] f32, "x_prev":
[B, D]}``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding.hints import shard_hint

Params = Dict[str, Any]


def _randn(gen: torch.Generator, shape, scale: float, dtype,
           shift: float = 0.0) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale + shift).to(dtype)


def _uniform(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=torch.float32).to(dtype)


# ================================================================= Mamba2 ==
def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, head dim P, heads H, state N)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    hp = cfg.ssm_head_dim
    return d_inner, hp, d_inner // hp, cfg.ssm_state


def init_mamba2(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Separate z / x / BC / dt projections, as in the reference."""
    d, dt, dev = cfg.d_model, cfg.tdtype, gen.device
    d_inner, _, nh, n = mamba_dims(cfg)
    k = cfg.conv_kernel
    return {
        "in_z": L.init_linear(gen, d, d_inner, dt),
        "in_x": L.init_linear(gen, d, d_inner, dt),
        "in_bc": L.init_linear(gen, d, 2 * n, dt),
        "in_dt": L.init_linear(gen, d, nh, dt),
        "conv_x_w": _randn(gen, (k, d_inner), 0.2, dt),
        "conv_x_b": torch.zeros(d_inner, dtype=dt, device=dev),
        "conv_bc_w": _randn(gen, (k, 2 * n), 0.2, dt),
        "conv_bc_b": torch.zeros(2 * n, dtype=dt, device=dev),
        "dt_bias": torch.zeros(nh, dtype=dt, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)).to(dt),
        "d_skip": torch.ones(nh, dtype=dt, device=dev),
        "norm": L.init_norm(d_inner, dt, dev),
        "out_proj": L.init_linear(gen, d_inner, d, dt),
    }


def _in_projections(p: Params, xin: torch.Tensor, cfg: ModelConfig):
    act = cfg.act_kernel
    return tuple(L.apply_linear(p[k], xin, act=act)
                 for k in ("in_z", "in_x", "in_bc", "in_dt"))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d + SiLU.  x: [B, T, C]; w: [K, C]."""
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + t] * w[i]
    return F.silu((out + b).to(torch.float32)).to(x.dtype)


def ssd_chunked(x: torch.Tensor, la: torch.Tensor, bm: torch.Tensor,
                cm: torch.Tensor, h0: torch.Tensor | None = None,
                chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  x[B, T, H, P] (dt-scaled input), la[B, T, H]
    (log decay per step, ≤ 0), bm / cm[B, T, N], h0[B, H, P, N] →
    (y[B, T, H, P] in x's dtype, final state [B, H, P, N] f32)."""
    b, t, h, p = x.shape
    n = bm.shape[-1]
    lc = min(chunk, t)
    tp = -(-t // lc) * lc
    if tp != t:          # padded steps have decay 0 (a no-op) and no input
        x = F.pad(x, (0, 0, 0, 0, 0, tp - t))
        la = F.pad(la, (0, 0, 0, tp - t))
        bm = F.pad(bm, (0, 0, 0, tp - t))
        cm = F.pad(cm, (0, 0, 0, tp - t))
    mask = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=x.device))
    hprev = (h0.to(torch.float32) if h0 is not None
             else torch.zeros(b, h, p, n, dtype=torch.float32,
                              device=x.device))
    ys = []
    for c0 in range(0, tp, lc):
        xk = x[:, c0:c0 + lc].to(torch.float32)             # [B, L, H, P]
        bk = bm[:, c0:c0 + lc].to(torch.float32)            # [B, L, N]
        ck = cm[:, c0:c0 + lc].to(torch.float32)
        cum = torch.cumsum(la[:, c0:c0 + lc], dim=1)        # Λ_i [B, L, H]
        total = cum[:, -1]                                   # [B, H]
        # intra-chunk: y_i += Σ_{j<=i} (C_i·B_j) exp(Λ_i − Λ_j) x_j.  Mask
        # BEFORE exp: for j > i the difference is positive and would
        # overflow
        cb = torch.einsum("bin,bjn->bij", ck, bk)
        diff = cum[:, :, None, :] - cum[:, None, :, :]      # [B, i, j, H]
        m = torch.exp(torch.where(mask[None, :, :, None], diff,
                                  torch.full_like(diff, -1e30)))
        # the three-operand products go pairwise in the reference's einsum
        # order (its contraction path): the same products, the same dots
        y = torch.einsum("bijh,bjhp->bihp",
                         torch.einsum("bij,bijh->bijh", cb, m), xk)
        # inter-chunk: y_i += exp(Λ_i) C_i · H_prev
        y = y + torch.einsum("binh,bhpn->bihp",
                             torch.einsum("bin,bih->binh", ck,
                                          torch.exp(cum)), hprev)
        # state at the chunk's end: exp(total) H_prev + Σ_j exp(Λ_L − Λ_j)
        # x_j B_j
        dte = torch.exp(total[:, None, :] - cum)            # [B, L, H]
        s_c = torch.einsum("bjhp,bjn->bhpn",
                           torch.einsum("bjh,bjhp->bjhp", dte, xk), bk)
        hprev = hprev * torch.exp(total)[:, :, None, None] + s_c
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :t]
    return y.to(x.dtype), hprev


def _ssd_out(p: Params, xin, z, x, dt, bm, cm, cfg: ModelConfig, h0=None):
    """dt-scaled SSD, the D skip, the gated norm and the out projection."""
    d_inner, hp, nh, _ = mamba_dims(cfg)
    b_, t_ = xin.shape[:2]
    a = -torch.exp(p["a_log"].to(torch.float32))           # [H] negative
    la = dt * a                                             # [B, T, H]
    xh = x.reshape(b_, t_, nh, hp)
    xdt = xh.to(torch.float32) * dt[..., None]
    y, hlast = ssd_chunked(xdt.to(xin.dtype), la, bm, cm, h0=h0)
    y = y + xh.to(torch.float32).to(xin.dtype) \
        * p["d_skip"][None, None, :, None].to(xin.dtype)
    y = y.reshape(b_, t_, d_inner)
    y = L.apply_norm(p["norm"], y) \
        * F.silu(z.to(torch.float32)).to(xin.dtype)
    return L.apply_linear(p["out_proj"], y.contiguous(),
                          act=cfg.act_kernel), hlast


def mamba2_forward(p: Params, xin: torch.Tensor, cfg: ModelConfig, *,
                   return_state: bool = False):
    """Full-sequence Mamba2 mixer, xin[B, T, D] → [B, T, D] (and, with
    ``return_state``, the state after the last token)."""
    n = cfg.ssm_state
    z, x_raw, bc_raw, dt = _in_projections(p, xin, cfg)
    x = _causal_conv(x_raw, p["conv_x_w"], p["conv_x_b"])
    bc = _causal_conv(bc_raw, p["conv_bc_w"], p["conv_bc_b"])
    bm, cm = bc[..., :n], bc[..., n:]
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    out, hlast = _ssd_out(p, xin, z, x, dt, bm, cm, cfg)
    if not return_state:
        return out
    km1, t_ = cfg.conv_kernel - 1, xin.shape[1]

    def tail(a):
        return a[:, -km1:] if t_ >= km1 else F.pad(a, (0, 0, km1 - t_, 0))

    return out, {"h": hlast, "conv_x": tail(x_raw), "conv_bc": tail(bc_raw)}


def mamba2_prefill_chunk(p: Params, xin: torch.Tensor,
                         state: Dict[str, torch.Tensor], lens: torch.Tensor,
                         cfg: ModelConfig
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One chunk of a state-carrying prefill: consume ``lens[b]`` tokens of
    row b on top of ``state`` and return the state for the next chunk.  The
    conv runs over ``[history, chunk]``, and padding past ``lens[b]`` has
    ``dt`` zeroed *after* softplus (decay 1, update 0), so the state is the
    state after exactly ``lens[b]`` tokens."""
    n = cfg.ssm_state
    t_ = xin.shape[1]
    km1 = cfg.conv_kernel - 1
    z, x_raw, bc_raw, dt = _in_projections(p, xin, cfg)
    stream_x = torch.cat([state["conv_x"].to(x_raw.dtype), x_raw], dim=1)
    stream_bc = torch.cat([state["conv_bc"].to(bc_raw.dtype), bc_raw], dim=1)
    x = _causal_conv(stream_x, p["conv_x_w"], p["conv_x_b"])[:, km1:]
    bc = _causal_conv(stream_bc, p["conv_bc_w"], p["conv_bc_b"])[:, km1:]
    bm, cm = bc[..., :n], bc[..., n:]
    valid = torch.arange(t_, device=xin.device)[None, :] \
        < lens.long()[:, None]
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    dt = torch.where(valid[:, :, None], dt, torch.zeros_like(dt))
    out, hlast = _ssd_out(p, xin, z, x, dt, bm, cm, cfg, h0=state["h"])
    # raw token t sits at stream index K-1+t: the K-1 tokens ending row b's
    # valid region are [lens, lens+K-2] (lens = 0: the incoming history)
    idx = lens.long()[:, None] + torch.arange(km1, device=xin.device)[None]

    def tail(s):
        return torch.gather(s, 1, idx[:, :, None].expand(-1, -1, s.shape[-1]))

    return out, {"h": hlast, "conv_x": tail(stream_x),
                 "conv_bc": tail(stream_bc)}


def mamba2_decode(p: Params, xin: torch.Tensor, state: Dict[str, torch.Tensor],
                  cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-step recurrent update, xin[B, 1, D]."""
    d_inner, hp, nh, n = mamba_dims(cfg)
    b = xin.shape[0]
    z, x_raw, bc_raw, dt = _in_projections(p, xin, cfg)

    def conv_step(hist, new, w, bias):
        window = torch.cat([hist.to(new.dtype), new[:, None]], dim=1)
        out = torch.einsum("bkc,kc->bc", window.to(torch.float32),
                           w.to(torch.float32))
        return (F.silu(out + bias.to(torch.float32)).to(new.dtype),
                window[:, 1:])

    x1, conv_x = conv_step(state["conv_x"], x_raw[:, 0], p["conv_x_w"],
                           p["conv_x_b"])
    bc1, conv_bc = conv_step(state["conv_bc"], bc_raw[:, 0], p["conv_bc_w"],
                             p["conv_bc_b"])
    b1, c1 = bc1[..., :n].to(torch.float32), bc1[..., n:].to(torch.float32)
    dt1 = F.softplus(dt[:, 0].to(torch.float32)
                     + p["dt_bias"].to(torch.float32))           # [B, H]
    dec = torch.exp(dt1 * -torch.exp(p["a_log"].to(torch.float32)))
    xh = x1.reshape(b, nh, hp).to(torch.float32)
    upd = torch.einsum("bhp,bn->bhpn", xh * dt1[..., None], b1)
    h = state["h"] * dec[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h, c1)
    y = y + xh * p["d_skip"].to(torch.float32)[None, :, None]
    y = y.reshape(b, 1, d_inner).to(xin.dtype)
    y = L.apply_norm(p["norm"], y) \
        * F.silu(z.to(torch.float32)).to(xin.dtype)
    out = L.apply_linear(p["out_proj"], y.contiguous(), act=cfg.act_kernel)
    return out, {"h": h, "conv_x": conv_x, "conv_bc": conv_bc}


def init_mamba2_state(cfg: ModelConfig, batch: int, device
                      ) -> Dict[str, torch.Tensor]:
    d_inner, hp, nh, n = mamba_dims(cfg)
    km1 = cfg.conv_kernel - 1
    return {"h": torch.zeros(batch, nh, hp, n, dtype=torch.float32,
                             device=device),
            "conv_x": torch.zeros(batch, km1, d_inner, dtype=cfg.tdtype,
                                  device=device),
            "conv_bc": torch.zeros(batch, km1, 2 * n, dtype=cfg.tdtype,
                                   device=device)}


# ================================================================== RWKV6 ==
RWKV_LORA = 64


def rwkv_dims(cfg: ModelConfig) -> Tuple[int, int]:
    """(heads, head dim)."""
    k = cfg.ssm_head_dim
    return cfg.d_model // k, k


def init_rwkv6(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, dt, dev = cfg.d_model, cfg.tdtype, gen.device
    return {
        # token-shift mix coefficients (r, k, v, g, w)
        "mix": _uniform(gen, (5, d), dt),
        "wr": L.init_linear(gen, d, d, dt),
        "wk": L.init_linear(gen, d, d, dt),
        "wv": L.init_linear(gen, d, d, dt),
        "wg": L.init_linear(gen, d, d, dt),
        "wo": L.init_linear(gen, d, d, dt),
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(xw @ A) @ B))
        "w0": _randn(gen, (d,), 0.5, dt, shift=-5.0),
        "w_lora_a": _randn(gen, (d, RWKV_LORA), d ** -0.5, dt),
        "w_lora_b": _randn(gen, (RWKV_LORA, d), RWKV_LORA ** -0.5, dt),
        "u_bonus": torch.zeros(d, dtype=dt, device=dev),
        # GroupNorm with one group per head
        "ln_x": {"scale": torch.ones(d, dtype=dt, device=dev),
                 "bias": torch.zeros(d, dtype=dt, device=dev)},
    }


def _head_groupnorm(p: Params, y: torch.Tensor, nh: int,
                    eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(groups=heads) over the last dim of y[..., D]."""
    shp = y.shape
    yf = y.to(torch.float32).reshape(*shp[:-1], nh, shp[-1] // nh)
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, unbiased=False, keepdim=True)
    yf = ((yf - mu) * torch.rsqrt(var + eps)).reshape(shp)
    return (yf * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(y.dtype)


def _rwkv_inputs(p: Params, x: torch.Tensor, x_prev: torch.Tensor,
                 cfg: ModelConfig):
    """The five token-shift lerps, r / k / v / g and the decay w, for
    x[B, T, D] and its shifted-by-one x_prev[B, T, D].  The decay LoRA is a
    plain matmul, as in the reference (outside Pallas there)."""
    act = cfg.act_kernel
    mix = p["mix"].to(torch.float32)
    xf, pf = x.to(torch.float32), x_prev.to(torch.float32)
    xr, xk, xv, xg, xw = [(pf + (xf - pf) * mix[i]).to(x.dtype)
                          for i in range(5)]
    r = L.apply_linear(p["wr"], xr, act=act)
    k = L.apply_linear(p["wk"], xk, act=act)
    v = L.apply_linear(p["wv"], xv, act=act)
    g = L.apply_linear(p["wg"], xg, act=act)
    lora = torch.tanh(torch.matmul(xw.to(torch.float32),
                                   p["w_lora_a"].to(torch.float32)))
    logw = p["w0"].to(torch.float32) + torch.matmul(
        lora, p["w_lora_b"].to(torch.float32))
    return r, k, v, g, torch.exp(-torch.exp(logw))   # w in (0, 1)


def _rwkv_out(p: Params, y: torch.Tensor, g: torch.Tensor, xin, nh: int,
              cfg: ModelConfig) -> torch.Tensor:
    y = _head_groupnorm(p["ln_x"], y.to(xin.dtype), nh)
    y = y * F.silu(g.to(torch.float32)).to(xin.dtype)
    return L.apply_linear(p["wo"], y.contiguous(), act=cfg.act_kernel)


def rwkv6_forward(p: Params, xin: torch.Tensor, cfg: ModelConfig, *,
                  return_state: bool = False):
    """Full-sequence RWKV6 time mix over xin[B, T, D] (a Python loop over
    T), from a zero state."""
    b, t, d = xin.shape
    nh, hk = rwkv_dims(cfg)
    x_prev = F.pad(xin, (0, 0, 1, 0))[:, :-1]
    r, k, v, g, w = _rwkv_inputs(p, xin, x_prev, cfg)
    rh, kh, vh = (a.reshape(b, t, nh, hk).to(torch.float32)
                  for a in (r, k, v))
    wh = w.reshape(b, t, nh, hk)
    u = p["u_bonus"].to(torch.float32).reshape(nh, hk)[None, :, :, None]
    s = torch.zeros(b, nh, hk, hk, dtype=torch.float32, device=xin.device)
    # pin the recurrence's operands to (batch → data, heads → model): the
    # reference anchors its time-major scan operands the same way
    dp = ("pod", "data")
    rh, kh, vh, wh = (shard_hint(a, dp, None, "model", None)
                      for a in (rh, kh, vh, wh))
    s = shard_hint(s, dp, "model", None, None)
    outs = []
    for i in range(t):
        kv = torch.einsum("bhk,bhv->bhkv", kh[:, i], vh[:, i])
        outs.append(torch.einsum("bhk,bhkv->bhv", rh[:, i], s + u * kv))
        s = s * wh[:, i, :, :, None] + kv
    y = shard_hint(torch.stack(outs, dim=1), dp, None, "model",
                   None).reshape(b, t, d)
    out = _rwkv_out(p, y, g, xin, nh, cfg)
    if not return_state:
        return out
    return out, {"wkv": s, "x_prev": xin[:, -1]}


def rwkv6_decode(p: Params, xin: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step of the time mix, xin[B, 1, D]."""
    b, _, d = xin.shape
    nh, hk = rwkv_dims(cfg)
    r, k, v, g, w = _rwkv_inputs(p, xin, state["x_prev"][:, None, :], cfg)
    rt, kt, vt = (a.reshape(b, nh, hk).to(torch.float32) for a in (r, k, v))
    wt = w.reshape(b, nh, hk)
    u = p["u_bonus"].to(torch.float32).reshape(nh, hk)[None, :, :, None]
    s = state["wkv"]
    kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
    out = torch.einsum("bhk,bhkv->bhv", rt, s + u * kv)
    y = _rwkv_out(p, out.reshape(b, 1, d), g, xin, nh, cfg)
    return y, {"wkv": s * wt[..., None] + kv, "x_prev": xin[:, 0]}


def init_rwkv_channel_mix(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.tdtype
    return {"mix": _uniform(gen, (2, d), dt),            # (k, r)
            "wk": L.init_linear(gen, d, f, dt),
            "wv": L.init_linear(gen, f, d, dt),
            "wr": L.init_linear(gen, d, d, dt)}


def rwkv_channel_mix(p: Params, x: torch.Tensor, x_prev: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Finch FFN: y = sigmoid(Wr x_r) ⊙ Wv relu(Wk x_k)²."""
    act = cfg.act_kernel
    mix = p["mix"].to(torch.float32)
    xf, pf = x.to(torch.float32), x_prev.to(torch.float32)
    xk = (pf + (xf - pf) * mix[0]).to(x.dtype)
    xr = (pf + (xf - pf) * mix[1]).to(x.dtype)
    k = L.apply_linear(p["wk"], xk, act=act)
    k = torch.square(F.relu(k.to(torch.float32))).to(x.dtype)
    r = torch.sigmoid(L.apply_linear(p["wr"], xr, act=act).to(torch.float32)
                      ).to(x.dtype)
    return r * L.apply_linear(p["wv"], k, act=act)


def init_rwkv6_state(cfg: ModelConfig, batch: int, device
                     ) -> Dict[str, torch.Tensor]:
    nh, hk = rwkv_dims(cfg)
    return {"wkv": torch.zeros(batch, nh, hk, hk, dtype=torch.float32,
                               device=device),
            "x_prev": torch.zeros(batch, cfg.d_model, dtype=cfg.tdtype,
                                  device=device)}
