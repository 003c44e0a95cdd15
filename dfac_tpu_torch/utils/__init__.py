"""Counterpart of :mod:`dfac_tpu.utils` (the ported subset)."""
