"""Plain PyTorch reference of the configurations (imports nothing of the program)."""
