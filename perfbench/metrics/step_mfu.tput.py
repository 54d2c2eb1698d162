"""The whole step's share of the chip's peak, in %: the working steps'
analytic bounds over their host wall times.  Moves output_tok_s."""
from perfbench.harness.readers import step_mfu


def read(rec):
    return step_mfu(rec)
