"""Rows decoded per decode step over the window: the change of the engine's
``active_slot_steps`` over the change of its ``steps`` (EngineStats).
Moves output_tok_s."""
from perfbench.harness.readers import decode_rows_per_step


def read(rec):
    return decode_rows_per_step(rec)
