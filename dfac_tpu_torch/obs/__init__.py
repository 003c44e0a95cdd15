"""Training UI: event dataclasses and visualizers."""
