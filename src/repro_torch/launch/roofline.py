"""Roofline terms of one dry-run cell (port of
``repro/launch/roofline.py``), with the NVIDIA H100 SXM's constants.

Three terms (seconds), per (arch × shape × mesh):

    compute    = FLOPs / (chips · peak FLOP/s)
    memory     = bytes / (chips · HBM bytes/s)   (+ the weight-stream term)
    collective = Σ over mesh axes of that axis's collective bytes
                 / (chips · that axis's link bytes/s)

FLOPs and bytes come from ``launch/op_cost.py`` over the unsharded step
(global), collective bytes from ``launch/comm_bytes.py`` (per device; the
dry-run multiplies by the chip count).

Constants, from NVIDIA's H100 Tensor Core GPU data sheet (H100 SXM column):
989.4 TFLOP/s dense bf16 tensor-core peak (1,979 with sparsity), 3.35 TB/s
of HBM3, NVLink 4 at 900 GB/s a GPU (450 GB/s a direction) inside an
8-GPU HGX node, and one 400 Gb/s InfiniBand NDR port a GPU (50 GB/s a
direction) across nodes.  A mesh axis whose ranks span more than one
8-GPU node (the production mesh's "model" axis of 16, and its "data" and
"pod" axes) crosses InfiniBand; an axis inside one node rides NVLink.
These are the card's limits, not measurements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

PEAK_FLOPS = 989.4e12        # bf16 dense tensor core / GPU
HBM_BW = 3.35e12             # bytes/s / GPU
NVLINK_BW = 450e9            # bytes/s / GPU, one direction, inside a node
IB_BW = 50e9                 # bytes/s / GPU, one direction, across nodes
NODE_GPUS = 8


def axis_link_bw(axis_sizes: Dict[str, int]) -> Dict[str, float]:
    """Link rate of each mesh axis: NVLink when the axis and every axis
    after it (the faster-varying ones, laid out inside a node first) fit in
    one 8-GPU node, else InfiniBand."""
    out, inner = {}, 1
    for name in reversed(list(axis_sizes)):
        inner *= axis_sizes[name]
        out[name] = NVLINK_BW if inner <= NODE_GPUS else IB_BW
    return out


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    model_flops: float
    # weights are TP-sharded over "model" but REPLICATED over "data"/"pod":
    # each data replica streams its own copy, so per-chip weight traffic is
    # w_bytes/model_shards, not w_bytes/chips.  ``weight_stream_bytes`` is the
    # total weight bytes read per step (× read count); ``model_shards`` the TP
    # degree.  hbm_bytes already contains w_bytes once (÷chips downstream);
    # the correction adds the replicated re-reads.
    weight_stream_bytes: float = 0.0
    model_shards: int = 0
    # global collective bytes by mesh axis and each axis's link rate; when
    # absent, every collective byte takes the slowest link (InfiniBand)
    coll_by_axis: Optional[Dict[str, float]] = None
    link_bw: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        extra = 0.0
        if self.model_shards and self.model_shards < self.chips:
            extra = self.weight_stream_bytes * (
                self.chips / self.model_shards - 1.0)
        return (self.hbm_bytes + extra) / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        if not self.coll_by_axis:
            return self.coll_bytes / (self.chips * IB_BW)
        return sum(b / (self.chips * self.link_bw[a])
                   for a, b in self.coll_by_axis.items())

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """useful work time / achievable step time (higher is better)."""
        t_star = self.model_flops / (self.chips * PEAK_FLOPS)
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_star / max(t_bound, 1e-12)

    def to_dict(self) -> Dict:
        return {
            "weight_stream_bytes": self.weight_stream_bytes,
            "model_shards": self.model_shards,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "coll_by_axis": self.coll_by_axis, "link_bw": self.link_bw,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def _leaves(tree):
    from repro_torch import tree as T
    from repro_torch.core.quantize import QuantizedTensor

    out = []
    for leaf in T.leaves(tree):
        if isinstance(leaf, QuantizedTensor):
            out += [leaf.packed, leaf.scales, leaf.zeros]
        else:
            out.append(leaf)
    return out


def weight_stream_bytes(tree) -> float:
    """Bytes to stream every weight once (int4-packed uint8 = 1 B a packed
    byte), floats at the width the card reads."""
    return float(sum(t.numel() * t.element_size() for t in _leaves(tree)))


def count_params(tree) -> Tuple[int, int]:
    """(total_param_count, embed_param_count) of an fp param tree."""
    from repro_torch.sharding.rules import map_with_path

    total = embed = 0

    def add(path, leaf):
        nonlocal total, embed
        total += leaf.numel()
        if "embed/table" in path or "lm_head" in path:
            embed += leaf.numel()

    map_with_path(add, tree)
    return total, embed


def model_flops_estimate(cfg, shape, n_params: int, n_embed: int) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode), N = active non-embed
    params (a MoE's experts scaled by top_k / num_experts)."""
    n = n_params - n_embed
    if cfg.moe is not None:
        e = cfg.moe
        expert_per_layer = 3 * cfg.d_model * e.d_expert * e.num_experts
        inactive = expert_per_layer * cfg.num_layers * (
            1 - e.top_k / e.num_experts)
        n = n - inactive
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * n * tokens
