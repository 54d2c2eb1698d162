"""The share of the profiled slice in which no kernel, copy or fill ran on
the device, in %.  Moves output_tok_s."""
from perfbench.harness.readers import device_idle_pct


def read(rec):
    return device_idle_pct(rec)
