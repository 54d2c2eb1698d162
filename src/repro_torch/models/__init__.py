"""Dense decoder model behind ``models/api.py``."""
