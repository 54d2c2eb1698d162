"""The harness: cell files, traffic, the serving loop, tracing, the check."""
