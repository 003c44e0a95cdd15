"""Counterpart of :mod:`dfac_tpu.io` (the ported subset)."""
