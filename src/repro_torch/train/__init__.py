"""The train step."""
