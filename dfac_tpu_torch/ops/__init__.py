"""Counterpart of :mod:`dfac_tpu.ops` (the ported subset)."""
