"""Paged-KV continuous-batching engine."""
