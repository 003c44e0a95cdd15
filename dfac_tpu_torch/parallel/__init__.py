"""Data-parallel training on one process per device (counterpart of :mod:`dfac_tpu.parallel`)."""

from dfac_tpu_torch.parallel.data_parallel import launch

__all__ = ["launch"]
