"""Drivers (serve)."""
