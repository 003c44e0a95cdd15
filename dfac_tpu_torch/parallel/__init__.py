"""Data parallelism on one process per device, multi-host clusters and sharded serving (counterpart of
:mod:`dfac_tpu.parallel`)."""

from dfac_tpu_torch.parallel.data_parallel import launch

__all__ = ["launch"]
