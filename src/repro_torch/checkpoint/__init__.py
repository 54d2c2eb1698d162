"""PTQ artifacts on disk: quantize once, serve many."""
