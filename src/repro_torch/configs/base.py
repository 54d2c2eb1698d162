"""Model / quantization configuration dataclasses (port of
``repro/configs/base.py``: the dense and MoE decoder families, GQA or
Multi-head Latent Attention).

The fields keep the reference's names and defaults so a config prints the
same in both packages.  Features the port has not covered yet stay as
fields and raise :class:`NotImplementedError` in :meth:`ModelConfig.check`
with the ``ROADMAP.md`` item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                      # per-expert FFN hidden dim
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe (others not ported yet)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // num_heads
    mixer: str = "attention"           # attention | mla
    mlp: str = "swiglu"
    rope: str = "standard"
    rope_theta: float = 1e4
    norm: str = "rmsnorm"
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    tie_embeddings: bool = False
    attn_bias: bool = False
    dtype: str = "bfloat16"
    # int8 KV page pools with per-(position, head) f32 scales
    kv_quant: bool = False
    # full-sequence attention (calibration, teacher-forced forward):
    # "chunked" (online-softmax PyTorch ops) | "flash" (the causal flash
    # kernel B4 for CUDA tensors, its plain version for CPU tensors)
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
        """Raise for the features the port does not cover yet."""
        if self.mixer not in ("attention", "mla"):
            raise NotImplementedError(
                f"mixer={self.mixer!r}: only GQA attention and MLA are ported "
                "(SSM mixers: ROADMAP.md queue A item 2)")
        if (self.mixer == "mla") != (self.mla is not None):
            raise ValueError(f"{self.name}: mixer={self.mixer!r} and "
                             f"mla={self.mla!r} disagree")
        if self.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"family={self.family!r}: only the dense and MoE decoders are "
                "ported (hybrid, SSM and encoder-decoder: ROADMAP.md queue A "
                "item 2)")
        if (self.family == "moe") != (self.moe is not None):
            raise ValueError(f"{self.name}: family={self.family!r} and "
                             f"moe={self.moe!r} disagree")
        if self.moe is not None and self.moe.router_dtype != "float32":
            raise NotImplementedError(
                f"{self.name}: router_dtype={self.moe.router_dtype!r}: the "
                "port's router computes in float32 only")
        if self.attn_impl not in ("chunked", "flash"):
            raise ValueError(f"attn_impl={self.attn_impl!r}: expected "
                             "'chunked' or 'flash'")
        if self.paged_attn_impl not in ("auto", "gather"):
            raise ValueError(
                f"paged_attn_impl={self.paged_attn_impl!r}: expected 'auto' "
                "or 'gather'")
        if self.rope != "standard" or self.norm != "rmsnorm" \
                or self.mlp != "swiglu" or self.attn_bias:
            raise NotImplementedError(
                f"{self.name}: only the Llama-style block (standard rope, "
                "rmsnorm, swiglu, no biases) is ported")
        return self


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    enabled: bool = True
    group_size: int = 128
    skip_lm_head: bool = True
    # the MoE router is a row compensation of smoothing, never quantized:
    # False raises in quantize_params
    skip_router: bool = True
    alpha: Optional[float] = None      # None → use searched value
    # W4A8 eligibility: a smoothing group whose worst post-smoothing
    # per-token int8 round-trip error exceeds this stays A16
    a8_threshold: float = 0.015
