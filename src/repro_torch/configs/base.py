"""Model / quantization configuration dataclasses (port of
``repro/configs/base.py``, dense path).

The fields keep the reference's names and defaults so a config prints the
same in both packages.  Features this slice has not ported yet stay as
fields and raise :class:`NotImplementedError` in :meth:`ModelConfig.check`
with the ``ROADMAP.md`` item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense (others not ported yet)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // num_heads
    mixer: str = "attention"
    mlp: str = "swiglu"
    rope: str = "standard"
    rope_theta: float = 1e4
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    attn_bias: bool = False
    dtype: str = "bfloat16"
    # int8 KV page pools with per-(position, head) f32 scales
    kv_quant: bool = False
    attn_impl: str = "chunked"
    # "auto": the paged-attention kernels for CUDA tensors, their plain
    # versions for CPU tensors; "gather": the dense page-gather oracle
    paged_attn_impl: str = "auto"
    # "a16" | "a8_prefill": prefill-chunk GEMMs of A8-eligible layers take
    # per-token int8 activations (the W4A8 kernel); decode stays A16 through
    # the token-count gate in kernels.ops
    act_quant: str = "a16"

    @property
    def hdim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def act_kernel(self) -> str:
        """The ``act=`` that model code hands to ``kernels.ops``; the ops
        gate (the weight's ``a8`` flag and the row count) decides whether the
        A8 body runs."""
        return "a8" if self.act_quant == "a8_prefill" else "a16"

    @property
    def tdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def check(self) -> "ModelConfig":
        """Raise for the features this slice of the port does not cover."""
        if self.mixer != "attention" or self.family != "dense":
            raise NotImplementedError(
                f"mixer={self.mixer!r}/family={self.family!r}: only the dense "
                "attention decoder is ported (ROADMAP.md queue A items 7-8)")
        if self.attn_impl != "chunked":
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r}: the flash kernel is not "
                "ported yet (ROADMAP.md queue B item 6, kernel B4)")
        if self.paged_attn_impl not in ("auto", "gather"):
            raise ValueError(
                f"paged_attn_impl={self.paged_attn_impl!r}: expected 'auto' "
                "or 'gather'")
        if self.rope != "standard" or self.norm != "rmsnorm" \
                or self.mlp != "swiglu" or self.tie_embeddings \
                or self.attn_bias:
            raise NotImplementedError(
                f"{self.name}: only the Llama-style block (standard rope, "
                "rmsnorm, swiglu, untied head, no biases) is ported")
        return self


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    enabled: bool = True
    group_size: int = 128
    skip_lm_head: bool = True
    alpha: Optional[float] = None      # None → use searched value
    # W4A8 eligibility: a smoothing group whose worst post-smoothing
    # per-token int8 round-trip error exceeds this stays A16
    a8_threshold: float = 0.015
