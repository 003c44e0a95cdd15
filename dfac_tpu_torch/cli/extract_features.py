"""``python -m dfac_tpu_torch.cli.extract_features`` — raw audio -> features.

Counterpart of ``dfac-extract-features`` (:mod:`dfac_tpu.cli.extract_features`)
with the same flags, defaults and outputs, plus ``--device``: runs the LFCC
front-end over a directory or archive of waveforms and writes a
``features.pkl`` (reference contract) or a memory-mapped ``.npy`` store.

Inputs: a directory of ``.npy`` / ``.wav`` files (mono, 16 kHz; uttid = file
stem) or one ``.npz`` archive mapping uttid -> waveform. Utterances are
sorted by uttid and cropped or zero-padded to ``--frames``.

``--method``: ``gemm`` (the fused GEMM front-end kernel, f32 DFT),
``fft-pallas`` (rFFT + the post-FFT kernel) or ``fft`` (plain PyTorch);
``--no-pallas`` is an alias for ``--method fft``. ``--device cuda`` (the
default) without a GPU is an error; nothing falls back to another device or
method.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _load_waveform(path: str, sample_rate: int) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32).reshape(-1)
    if path.endswith(".wav"):
        from scipy.io import wavfile

        sr, data = wavfile.read(path)
        if sr != sample_rate:
            raise ValueError(f"{path}: sample rate {sr} != {sample_rate}")
        if data.dtype.kind == "i":
            data = data / float(np.iinfo(data.dtype).max)
        if data.ndim > 1:
            data = data.mean(axis=1)
        return data.astype(np.float32)
    raise ValueError(f"unsupported audio file: {path}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Extract LFCC+delta+delta-delta features on the GPU.")
    p.add_argument("--audio", required=True,
                   help="directory of .npy/.wav files, or a single .npz archive {uttid: waveform}")
    p.add_argument("--out", required=True,
                   help="output features.pkl path, or a directory when --format npy")
    p.add_argument("--format", default="pkl", choices=["pkl", "npy"],
                   help="pkl = reference-contract features.pkl; npy = memory-mapped corpus "
                   "store directory (io/npy_store.py)")
    p.add_argument("--frames", type=int, default=321,
                   help="frames per utterance; waveforms are cropped/zero-padded to match")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--method", default="gemm", choices=["gemm", "fft-pallas", "fft"],
                   help="front-end: gemm = fused GEMM front-end kernel; fft-pallas = rFFT + "
                   "post-FFT kernel; fft = plain PyTorch")
    p.add_argument("--no-pallas", action="store_true", help="alias for --method fft")
    p.add_argument("--tensor-format", default="auto", choices=["auto", "torch", "numpy"])
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (no implicit fallback)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from dfac_tpu_torch.device import resolve_device
    from dfac_tpu_torch.features.lfcc import LFCCConfig, lfcc_features_batch
    from dfac_tpu_torch.io.pickle_io import write_features

    device = resolve_device(args.device)
    cfg = LFCCConfig(sample_rate=args.sample_rate)
    n_samples = cfg.num_samples(args.frames)

    uttids: list[str] = []
    waves: list[np.ndarray] = []
    if args.audio.endswith(".npz"):
        with np.load(args.audio) as archive:
            for uttid in sorted(archive.files):
                uttids.append(uttid)
                waves.append(archive[uttid].astype(np.float32).reshape(-1))
    else:
        for name in sorted(os.listdir(args.audio)):
            if not name.endswith((".npy", ".wav")):
                continue
            uttids.append(os.path.splitext(name)[0])
            waves.append(_load_waveform(os.path.join(args.audio, name), args.sample_rate))
    if not uttids:
        raise SystemExit(f"no waveforms found in {args.audio}")

    fixed = np.zeros((len(waves), n_samples), np.float32)
    for i, w in enumerate(waves):
        n = min(len(w), n_samples)
        fixed[i, :n] = w[:n]

    method = "fft" if args.no_pallas else args.method
    t_run = time.perf_counter()
    feats = lfcc_features_batch(fixed, cfg, batch_size=args.batch_size, method=method, device=device)
    elapsed = time.perf_counter() - t_run
    if args.format == "npy":
        from dfac_tpu_torch.data.pipeline import ArrayDataset
        from dfac_tpu_torch.io.npy_store import save_npy_dataset

        save_npy_dataset(ArrayDataset(uttids=uttids, features=feats), args.out)
    else:
        write_features(args.out, uttids, feats, tensor_format=args.tensor_format)
    print(f"wrote {len(uttids)} x {feats.shape[1]}x{feats.shape[2]} features to {args.out}")
    if elapsed > 0:
        where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(
            f"throughput: {len(uttids) / elapsed:,.1f} utt/s over {elapsed:.2f}s on {where} "
            f"(method {method}, batch {args.batch_size}; host round trip included)"
        )


if __name__ == "__main__":
    main()
