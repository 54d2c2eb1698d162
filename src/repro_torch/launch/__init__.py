"""Drivers (serve, train, the trace viewer) and the card's measurement
scripts."""
