"""deep-fake-audio-classifier on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of :mod:`dfac_tpu`, module for module: each file
here mirrors the path of its JAX counterpart, and the JAX package is the
reference the port is tested against. This package imports ``torch`` and
never ``jax``, ``flax``, ``optax`` or ``dfac_tpu``.

Ported so far (the CNN2D serving slice, extraction, the probes and
CNN2D training):
  features  LFCC config, host constants, framing, deltas, rFFT composition
  ops       the GEMM front-end, the post-FFT kernel, the fused conv block,
            the pool and conv-probe kernels (hand-written CUDA kernels for
            sm_90a, each beside its plain PyTorch version), the nvcc/ctypes
            build, the EER on the host and on the device
  models    CNN2D (reference state_dict names, byte-quantized dropout), BN
            folding, serving chains
  utils     JAX variables <-> state_dict, optax Adam moments -> torch's
  train     the trainer, optimizer policy and plateau schedule, checkpoints
            (read and write, the JAX package's format), evaluation, scoring
  data      datasets, shuffled and padded batches, augmentation
  io / obs  pickled-DataFrame contract, .npy store, prefetch; the training
            UI contract
  cli       train, predict, evaluate, reproduce_reference, extract_features
"""

__version__ = "0.1.0"
