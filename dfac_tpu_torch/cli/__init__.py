"""Counterpart of :mod:`dfac_tpu.cli` (the ported subset)."""
