"""deep-fake-audio-classifier on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of :mod:`dfac_tpu`, module for module: each file
here mirrors the path of its JAX counterpart, and the JAX package is the
reference the port is tested against. This package imports ``torch`` and
never ``jax``, ``flax``, ``optax`` or ``dfac_tpu``.

Ported so far (the CNN2D serving slice):
  features  LFCC config, host constants, framing, deltas, rFFT composition
  ops       the GEMM front-end and the fused conv block (hand-written CUDA
            kernels for sm_90a, each beside its plain PyTorch version),
            the nvcc/ctypes build, host EER
  models    CNN2D (reference state_dict names), BN folding, serving chains
  utils     JAX variables -> state_dict conversion
  train     checkpoint loading, masked batch scoring
  io / data pickled-DataFrame contract, static-shape batches, prefetch
  cli       predict (--fast) and evaluate (score-file mode)
"""

__version__ = "0.1.0"
