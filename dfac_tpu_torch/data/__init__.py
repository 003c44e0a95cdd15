"""Counterpart of :mod:`dfac_tpu.data` (the ported subset)."""
