"""The W4A16 GEMMs' (K1, B6) share of their roofline in the profiled
slice, in %.  Moves output_tok_s."""
from perfbench.harness.readers import kernel_roofline
from perfbench.roofline.count import w4_calls

# K1 (csrc/w4a16_matmul.cu) and B6 (csrc/w4a16_grouped.cu) run the tile
# a16_kernel of csrc/w4a16_tile.cuh; split-K partials reduce in
# splitk_reduce (csrc/w4_ring.cuh)
PATTERN = r"a16_kernel|splitk_reduce"


def read(rec):
    return kernel_roofline(rec, w4_calls, PATTERN)
