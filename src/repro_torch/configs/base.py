"""Model / quantization / training configuration dataclasses (port of
``repro/configs/base.py``: the dense, VLM-stub and MoE decoder families,
GQA or Multi-head Latent Attention, the Zamba2-style hybrid (Mamba2 plus a
weight-shared attention block), the attention-free RWKV6 stack and the
Whisper-style encoder-decoder).

The fields keep the reference's names and defaults so a config prints the
same in both packages.  Features the port has not covered yet stay as
fields and raise :class:`NotImplementedError` in :meth:`ModelConfig.check`
with the ``ROADMAP.md`` item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
class HybridConfig:
    """Zamba2-style: mamba2 backbone + weight-shared attention block."""
    attn_every: int = 6                # shared attn after every N mamba layers


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | hybrid | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // num_heads
    mixer: str = "attention"           # attention | mla | mamba2 | rwkv6
    mlp: str = "swiglu"                # swiglu | gelu
    rope: str = "standard"             # standard | 2d | mrope | none
    rope_theta: float = 1e4
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    hybrid: Optional[HybridConfig] = None
    ssm_state: int = 0                 # mamba2 state size N
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    encdec: bool = False               # whisper
    enc_layers: int = 0
    tie_embeddings: bool = False
    attn_bias: bool = False            # biases on q/k/v/o and the GELU MLP
    dtype: str = "bfloat16"
    # long-context marker (a sub-quadratic mixer), as in the reference
    subquadratic: bool = False
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
        if self.mixer not in ("attention", "mla", "mamba2", "rwkv6"):
            raise NotImplementedError(
                f"mixer={self.mixer!r}: the port has GQA attention, MLA, "
                "Mamba2 and RWKV6")
        if (self.mixer == "mla") != (self.mla is not None):
            raise ValueError(f"{self.name}: mixer={self.mixer!r} and "
                             f"mla={self.mla!r} disagree")
        if self.family not in ("dense", "moe", "vlm", "hybrid", "ssm",
                               "audio"):
            raise NotImplementedError(
                f"family={self.family!r}: the port has the dense, VLM-stub, "
                "MoE, hybrid and SSM decoders and the audio encoder-decoder")
        if (self.family == "audio") != self.encdec or (
                self.encdec and (self.mixer != "attention"
                                 or self.enc_layers < 1)):
            raise ValueError(f"{self.name}: family={self.family!r}, encdec="
                             f"{self.encdec!r}, mixer={self.mixer!r} and "
                             f"enc_layers={self.enc_layers} disagree (an "
                             "audio config is a GQA encoder-decoder)")
        if (self.family == "moe") != (self.moe is not None):
            raise ValueError(f"{self.name}: family={self.family!r} and "
                             f"moe={self.moe!r} disagree")
        if (self.family == "hybrid") != (self.hybrid is not None) or (
                self.family == "hybrid" and self.mixer != "mamba2"):
            raise ValueError(f"{self.name}: family={self.family!r}, "
                             f"mixer={self.mixer!r} and hybrid="
                             f"{self.hybrid!r} disagree (a hybrid stack is "
                             "Mamba2 with a HybridConfig)")
        if (self.family == "ssm") != (self.mixer in ("mamba2", "rwkv6")
                                      and self.family != "hybrid"):
            raise ValueError(f"{self.name}: family={self.family!r} and "
                             f"mixer={self.mixer!r} disagree")
        if self.family == "ssm" and self.mixer == "mamba2":
            raise NotImplementedError(
                f"{self.name}: a pure Mamba2 stack has no config in the "
                "registry; the port serves Mamba2 in the hybrid layout")
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
        # RWKV6 has no attention, so no rotary embedding to pick; the
        # encoder-decoder adds sinusoidal positions to its inputs instead
        ropes = ("standard", "2d", "mrope") + (
            ("none",) if self.mixer == "rwkv6" or self.encdec else ())
        for field, ported in (("rope", ropes),
                              ("norm", ("rmsnorm", "layernorm")),
                              ("mlp", ("swiglu", "gelu"))):
            if getattr(self, field) not in ported:
                raise NotImplementedError(
                    f"{self.name}: {field}={getattr(self, field)!r}: the port "
                    f"has {ported}")
        if self.mlp == "gelu" and self.moe is not None:
            raise NotImplementedError(
                f"{self.name}: the MoE experts are SwiGLU only")
        return self


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One dry-run (input-shape) cell, the reference's four."""
    name: str                          # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatch: Optional[int] = None   # per-device microbatching (grad accum)
    remat: str = "block"               # none | block | full
    zero_sharded_optimizer: bool = True
    grad_compression: str = "none"     # none | int8_ef
