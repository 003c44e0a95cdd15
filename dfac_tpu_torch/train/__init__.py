"""Counterpart of :mod:`dfac_tpu.train` (the ported subset)."""
