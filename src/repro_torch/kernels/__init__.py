"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) with their plain
PyTorch versions beside them; ``ops.py`` dispatches by device.

Each CUDA wrapper keeps a plain ``launches`` counter that it bumps only where
it launches its kernel, so a run can show that a path went through them.  A
CUDA graph replay runs no Python: its owner adds the launches it captured
(:func:`add_launch_counts`) at every replay.
"""
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import w4a16_grouped as _w4g
from repro_torch.kernels import w4a16_matmul as _w4

#: kernel name → CUDA wrapper carrying the ``launches`` counter
WRAPPERS = {
    "w4a16_matmul": _w4.w4a16_matmul_cuda,
    "gqa_paged_decode": _pa.gqa_paged_attention_cuda,
    "gqa_paged_prefill": _pa.gqa_paged_prefill_cuda,
    "w4a8_matmul": _w4.w4a8_matmul_cuda,
    "gqa_paged_decode_int8": _pa.gqa_paged_attention_int8_cuda,
    "gqa_paged_prefill_int8": _pa.gqa_paged_prefill_int8_cuda,
    "w4a16_grouped": _w4g.w4a16_grouped_cuda,
    "w4a8_grouped": _w4g.w4a8_grouped_cuda,
    "flash_attention": _fa.flash_attention_cuda,
    "mla_paged_decode": _pa.mla_paged_attention_cuda,
    "mla_paged_decode_int8": _pa.mla_paged_attention_int8_cuda,
    "mla_paged_prefill": _pa.mla_paged_prefill_cuda,
    "mla_paged_prefill_int8": _pa.mla_paged_prefill_int8_cuda,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (kernel name → launches, possibly negative) to the
    wrappers' counters."""
    for name, n in counts.items():
        WRAPPERS[name].launches += n
