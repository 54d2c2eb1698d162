"""The synthetic, resumable token pipeline."""
