"""Sharding rules and hints (port of ``repro/sharding``)."""
