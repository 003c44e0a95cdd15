"""Shared pieces of the benchmark: loading by name, the run record, seeds, peaks, the device trace."""
