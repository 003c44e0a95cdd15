"""Counterparts of the repository's ``scripts/`` probes (the ported subset).

Each module has the file name of the probe it ports and runs on the card
by default: ``python -m dfac_tpu_torch.scripts.<probe> [--device cpu]``.
"""
