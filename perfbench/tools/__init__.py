"""Chip-side tools: correctness readings and the knee sweep."""
