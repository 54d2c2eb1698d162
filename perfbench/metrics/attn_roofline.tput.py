"""The paged attention's (K2, K3) share of its roofline in the profiled
slice, in %.  Moves output_tok_s."""
from perfbench.harness.readers import kernel_roofline
from perfbench.roofline.count import attn_calls

# K2 (csrc/gqa_paged_decode.cu: the split-KV kernel, its combine, the
# general path) and K3 (csrc/gqa_paged_prefill.cu: tensor-core and SIMT
# tiles)
PATTERN = (r"decode_split_kernel|decode_general_kernel|combine_kernel"
           r"|prefill_tc_kernel|prefill_simt_kernel")


def read(rec):
    return kernel_roofline(rec, attn_calls, PATTERN)
