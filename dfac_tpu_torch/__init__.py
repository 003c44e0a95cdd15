"""deep-fake-audio-classifier on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of :mod:`dfac_tpu`, module for module: each file
here mirrors the path of its JAX counterpart, and the JAX package is the
reference the port is tested against. This package imports ``torch`` and
never ``jax``, ``flax``, ``optax`` or ``dfac_tpu``.

Ported so far (the CNN2D serving slice, extraction, the probes, CNN2D
and CNN1D training, the submission path: CNN1D, the normalizer, the CAE
scorer, score fusion and the ensembles; the reference's two other
trainers, the CAE's and the dlqueen detector's; the zoo and bf16
training; int8 serving, the host ingest casts, embedding anomaly
scoring, the data tools and profiler traces):
  features  LFCC config, host constants, framing, deltas, rFFT composition
  ops       the GEMM front-end, the post-FFT kernel, the fused conv block,
            the w8a8 int8 conv block, the pool and conv-probe kernels
            (hand-written CUDA kernels for sm_90a, each beside its plain
            PyTorch version), the nvcc/ctypes build, the EER on the host
            and on the device
  models    CNN2D, CNN1D, the ConvAutoencoder, the DeepfakeDetector, the
            zoo (reference state_dict names, byte-quantized dropout), BN
            folding, serving chains (f32, bf16, int8 ingest, w8a8)
  utils     JAX variables <-> state_dict, optax Adam moments -> torch's
  train     the trainers (CNN2D/CNN1D, the CAE, the detector), optimizer
            policy and plateau schedule, checkpoints (read and write, the
            JAX package's format), evaluation, scoring, CAE scoring and
            evaluation
  data      datasets, shuffled and padded batches, augmentation, the
            bonafide-fitted feature normalizer
  ensemble  min-max fusion of CNN and CAE scores, the alpha sweep,
            checkpoint means, OC-SVM / GMM anomaly scores on embeddings
  io / obs  pickled-DataFrame contract, .npy store, prefetch, the
            submission artifact, the bf16 / int8 ingest casts; the
            training UI contract, the dashboards, profiler traces
  cli       train, predict, evaluate, reproduce_reference, extract_features,
            evaluate_cae, predict_hybrid, hybrid_ensemble, ensemble,
            generate_submission, train_cae, train_detector, benchmark,
            compare_kernels, compare_normalization, data_tools
"""

__version__ = "0.1.0"
