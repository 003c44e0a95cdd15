"""Operation and byte counts from the shapes, per model and per kernel."""
