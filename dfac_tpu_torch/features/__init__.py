"""Counterpart of :mod:`dfac_tpu.features` (the ported subset)."""
