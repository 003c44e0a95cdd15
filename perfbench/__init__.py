"""The port's benchmark: see ``run.py``."""
