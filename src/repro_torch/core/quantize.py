"""Group-wise 4-bit asymmetric RTN quantization (SmoothQuant+ §2.1, eq. 1)
and per-token int8 activation quantization (W4A8 prefill) — port of
``repro/core/quantize.py``.

Conventions are the reference's, bit for bit: a linear weight is
``W[Ci, Co]`` (``Y = X @ W``); groups run along the input-channel axis with
one ``scale``/``zero`` per (group, output channel); two int4 codes pack per
uint8 in the *group-split* layout — within each group of ``G`` rows, packed
row ``r < G/2`` holds code ``q[g*G + r]`` in the low nibble and
``q[g*G + G/2 + r]`` in the high nibble.  ``torch.round`` rounds half to even
like ``jnp.round``, so codes, scales and zeros match the reference exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

NBITS = 4
QMAX = (1 << NBITS) - 1  # 15
DEFAULT_GROUP_SIZE = 128


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """A group-wise int4-quantized weight, packed 2 codes / uint8.

    packed: uint8[*lead, Ci//2, Co]; scales/zeros: dtype[*lead, Ci//G, Co]
    (zeros stored float-domain, integer-valued: ``Ŵ = (q − zeros)·scales``).
    Leading (stack) dims are indexable with ``qt[i]``.  ``a8`` is the
    calibration verdict that this weight's inputs are safe for per-token
    int8 activations; ``kernels.ops`` takes the W4A8 body only when it is
    set.
    """

    packed: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor
    a8: bool = True

    @property
    def shape(self) -> Tuple[int, ...]:
        return (*self.packed.shape[:-2], self.packed.shape[-2] * 2,
                self.packed.shape[-1])

    @property
    def ndim(self) -> int:
        return self.packed.ndim

    @property
    def group_size(self) -> int:
        return (self.packed.shape[-2] * 2) // self.scales.shape[-2]

    @property
    def dtype(self) -> torch.dtype:
        return self.scales.dtype

    def __getitem__(self, idx) -> "QuantizedTensor":
        if self.packed.ndim < 3:
            raise IndexError("QuantizedTensor[...] indexes leading stack dims "
                             "only; this tensor is 2-D")
        return QuantizedTensor(self.packed[idx], self.scales[idx],
                               self.zeros[idx], self.a8)

    def map(self, fn) -> "QuantizedTensor":
        """Apply ``fn`` to all three arrays (e.g. ``.to(device)``)."""
        return QuantizedTensor(fn(self.packed), fn(self.scales),
                               fn(self.zeros), self.a8)

    def nbytes_quant(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.packed, self.scales, self.zeros))


def _check_nd(w: torch.Tensor) -> None:
    if w.ndim < 2:
        raise ValueError(f"expected >=2-D weight, got shape {tuple(w.shape)}")


def _grouped(w: torch.Tensor, group_size: int) -> torch.Tensor:
    *lead, ci, co = w.shape
    return w.to(torch.float32).reshape(*lead, ci // group_size, group_size, co)


def compute_qparams(w: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(group, out-channel) asymmetric min/max qparams, f32
    ``[*lead, Ci//G, Co]`` each."""
    _check_nd(w)
    if w.shape[-2] % group_size != 0:
        raise ValueError(
            f"Ci={w.shape[-2]} not divisible by group_size={group_size}")
    wf = _grouped(w, group_size)
    wmax = wf.amax(dim=-2)
    wmin = wf.amin(dim=-2)
    scales = (wmax - wmin) / QMAX
    scales = torch.where(scales <= 0, torch.ones_like(scales), scales)
    zeros = torch.round(-wmin / scales)
    return scales, zeros


def quantize_codes(w: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
                   group_size: int = DEFAULT_GROUP_SIZE) -> torch.Tensor:
    """RTN codes in [0, 15] → uint8[*lead, Ci, Co] (unpacked)."""
    wf = _grouped(w, group_size)
    q = torch.round(wf / scales.unsqueeze(-2)) + zeros.unsqueeze(-2)
    return q.clamp(0, QMAX).to(torch.uint8).reshape(w.shape)


def pack_codes(q: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE
               ) -> torch.Tensor:
    """Pack uint8 codes into uint8[*lead, Ci//2, Co], group-split layout."""
    *lead, ci, co = q.shape
    if ci % group_size != 0 or group_size % 2 != 0:
        raise ValueError(f"Ci={ci} / group_size={group_size} incompatible")
    qg = q.reshape(*lead, ci // group_size, 2, group_size // 2, co)
    return (qg[..., 0, :, :] | (qg[..., 1, :, :] << 4)).reshape(
        *lead, ci // 2, co)


def unpack_codes(packed: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE
                 ) -> torch.Tensor:
    """Inverse of :func:`pack_codes` → uint8[*lead, Ci, Co]."""
    *lead, ci2, co = packed.shape
    h = group_size // 2
    pg = packed.reshape(*lead, ci2 // h, h, co)
    return torch.cat([pg & 0x0F, (pg >> 4) & 0x0F], dim=-2).reshape(
        *lead, ci2 * 2, co)


def quantize(w: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE,
             dtype: torch.dtype | None = None) -> QuantizedTensor:
    """Group-wise asymmetric 4-bit RTN quantization of ``W[*lead, Ci, Co]``.
    A meta weight gives empty meta leaves of the same shapes and dtypes
    (the dry-run's quantized tree; nothing is computed)."""
    _check_nd(w)
    dtype = dtype or w.dtype
    if w.device.type == "meta":
        *lead, ci, co = w.shape
        if ci % group_size != 0:
            raise ValueError(
                f"Ci={ci} not divisible by group_size={group_size}")
        grid = (*lead, ci // group_size, co)
        return QuantizedTensor(
            torch.empty(*lead, ci // 2, co, dtype=torch.uint8, device="meta"),
            torch.empty(grid, dtype=dtype, device="meta"),
            torch.empty(grid, dtype=dtype, device="meta"))
    scales, zeros = compute_qparams(w, group_size)
    q = quantize_codes(w, scales, zeros, group_size)
    return QuantizedTensor(pack_codes(q, group_size), scales.to(dtype),
                           zeros.to(dtype))


def dequantize(qt: QuantizedTensor, dtype: torch.dtype | None = None
               ) -> torch.Tensor:
    """Ŵ = (q − zero) · Δ, back to ``[*lead, Ci, Co]``."""
    dtype = dtype or qt.dtype
    q = unpack_codes(qt.packed, qt.group_size).to(torch.float32)
    *lead, ci, co = q.shape
    g = qt.scales.shape[-2]
    qg = q.reshape(*lead, g, ci // g, co)
    w = (qg - qt.zeros.unsqueeze(-2).to(torch.float32)) \
        * qt.scales.unsqueeze(-2).to(torch.float32)
    return w.reshape(*lead, ci, co).to(dtype)


def fake_quantize(w: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE
                  ) -> torch.Tensor:
    """quantize→dequantize round trip in one shot (used by the α search)."""
    _check_nd(w)
    ci = w.shape[-2]
    if ci % group_size != 0 or ci < group_size:
        raise ValueError(f"Ci={ci} incompatible with group_size={group_size}")
    wf = _grouped(w, group_size)
    wmax = wf.amax(dim=-2, keepdim=True)
    wmin = wf.amin(dim=-2, keepdim=True)
    scales = (wmax - wmin) / QMAX
    scales = torch.where(scales <= 0, torch.ones_like(scales), scales)
    zeros = torch.round(-wmin / scales)
    q = (torch.round(wf / scales) + zeros).clamp(0, QMAX)
    return ((q - zeros) * scales).reshape(w.shape).to(w.dtype)


# ------------------------------------------------------ A8 activations -----
ACT_QMAX = 127  # symmetric int8


def quantize_acts_per_token(x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8: ``x[..., Ci]`` → ``(codes int8[..., Ci],
    scales f32[..., 1])`` with ``x ≈ codes * scales``.  The reference's
    operation order (``max(amax, 1e-8) / 127``, then ``round(x / scale)``),
    so the codes match it bit for bit."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scales = torch.clamp_min(amax, 1e-8) / ACT_QMAX
    codes = torch.round(xf / scales).clamp(-ACT_QMAX, ACT_QMAX).to(
        torch.int8)
    return codes, scales


def a8_roundtrip_error(x: torch.Tensor) -> torch.Tensor:
    """Worst per-token relative RMS error of the int8 activation round trip
    (a scalar): the per-layer A8-eligibility statistic."""
    xf = x.to(torch.float32).reshape(-1, x.shape[-1])
    codes, scales = quantize_acts_per_token(xf)
    err = codes.to(torch.float32) * scales - xf
    num = torch.sqrt((err * err).mean(dim=-1))
    den = torch.sqrt((xf * xf).mean(dim=-1))
    return (num / torch.clamp_min(den, 1e-8)).max()


def quantization_loss(w: torch.Tensor, x_stat: torch.Tensor,
                      group_size: int = DEFAULT_GROUP_SIZE) -> torch.Tensor:
    """Activation-weighted quantization loss ``||diag(x)·(W − Ŵ)||²`` (paper
    eq. 4), a scalar: ``x_stat[..., Ci]`` is a per-input-channel activation
    magnitude (channel max, or AWQ's mean), so the loss costs O(params),
    not O(calibration tokens × params)."""
    err = (w - fake_quantize(w, group_size)).to(torch.float32)
    return ((err * x_stat.to(torch.float32)[..., :, None]) ** 2).sum()
