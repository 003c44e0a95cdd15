#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (``dfac_tpu_torch``) end to end on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; each prints its lines, headed by the seconds since the
start, and any failure ends the run with a non-zero exit code and no result
line:

1. device   torch / CUDA / nvcc versions, the card's name and power limit
2. build    every kernel from ``dfac_tpu_torch/csrc`` (nvcc, sm_90a), with
            ptxas' registers and spills (the probe kernels' and K4's always,
            others' where there are any) and the dynamic shared memory of each
            kernel; ``cuobjdump -sass`` shows that the CUDA-core conv1
            (``conv1_checksum``: v1, d) has no tensor-core instruction and
            v4's ``conv1_emit`` has ``HMMA``
3. K1       the GEMM front-end kernel against its plain version, B=128
            waveforms of 51,520 samples, bf16 and f32; a second call of each
            mode equal to the first bit for bit
4. K4       the post-FFT kernel against its plain version on the rFFT power
            of the same waveforms (41,088 rows) and of the first 64 (20,544),
            a second call equal bit for bit, and the rFFT front-end with it
            against the plain one
5. K2       the fused conv-block kernel against its plain version at the
            three serving block shapes at B=128, bf16 (a second call equal
            bit for bit) and f32
6. slice    waveforms -> front-end -> three fused blocks -> scores at full
            CNN2D width (weights from a seed), against the all-plain chain
            and the f32 model; the launch counters must show 1 front-end and
            3 conv-block launches per batch
7. CLI      ``python -m dfac_tpu_torch.cli.predict --fast --bf16`` on a
            synthetic 512-utterance features.pkl, then the evaluate CLI; then
            ``predict --fast``'s default f32 chain in process on the same
            features (3 conv-block launches per batch, scores against the
            f32 model)
8. extract  the extraction driver on 512 utterances at B=64, once per method
            (gemm, fft-pallas, fft): one K1 launch per batch for gemm, one K4
            launch per batch for fft-pallas, none for fft; the methods
            against each other
9. extract-cli  ``python -m dfac_tpu_torch.cli.extract_features`` on a
            512-utterance .npz of varied lengths, as features.pkl and as a
            .npy store (identical features), then predict on the store
            against the slice's scores of the same padded waveforms
10. K5      the standalone (2,1) time-pool kernel against its plain version
            at the pool probe's two shapes at B=512 (bit for bit), at odd T,
            in f32 and on rows that are not 16-byte vectors
11. conv-probe  the conv-probe checksum kernels, cases g, h, i, j, k, against
            their plain versions at stage 13's shapes at B=512, bf16, one
            launch per call, a second call equal bit for bit, and every
            output y (g, h, i: the conv1 kernel ``conv1_tc``; j, k: the
            conv2/conv3 kernel)
12. conv-pass  stages 11, 12, 14 and 15's kernels (K7: v0-v4, K8: a, c, d,
            f, K10: h2, i2, j2, K11: j3, j4, j5, c2) against their plain
            versions at the stages' shapes at B=512, bf16: the checksums
            within 1e-5 of sum |y|, v4's emitted tensor within one bf16 last
            bit; one launch per call under the stage's counter, a second
            call equal bit for bit; for the conv cases (``conv1_checksum``:
            v1, d; ``conv1_tc``: v2, v3, a, c, h2, i2, c2; the conv2/conv3
            kernel: f, j2-j5) also every output y within atol 1e-4 + rtol
            1e-5
13. probes  the probes' path: ``pallas_err_probe``, ``train_opt_probe
            --stages 11,12,13,14,15`` and ``pool_kernel_probe`` as ``python
            -m`` at their defaults: exit 0, their result lines, logits of
            the ``pallas`` chain within 2e-2 of ``reduce_window``; each
            prints its run's launch counters (a new process, so they start
            at 0), which must show the conv-probe kernels (for
            ``train_opt_probe`` K9, K7, K8, K10 and K11, each once per case
            call), K5 for the pool probe (twice per batch of its ``pallas``
            variant), and nothing else
14. timing  slice utt/s over 8,192 on-device utterances at B=128 and
            ``predict --fast``'s f32 chain over 2,048 on-device feature
            tensors at B=128 (``dfac_tpu_torch.chain_rates``: median of 7,
            host clock ending in a synchronize), extraction utt/s per
            method at B=64 with and without the driver's host round trip,
            each kernel against its plain version with CUDA events, in turns,
            K4 (B=128 and B=64) and K7's v0 also by their device time a launch
            (``torch.profiler``'s kernel records; CUDA events over launches
            queued behind a spin kernel where the profiler keeps no record
            in three passes), each K1 mode, each K2 block in bf16 and in f32 and each probe
            case beside its own bound, rFFT + K4 against K1, K5 against
            ``F.avg_pool2d``, and controls: cuBLAS's DFT product alone in
            bf16 and f32 for K1, cuDNN's conv alone for each K2 block in
            bf16 and in f32, a write of block 1's output size in each
            (``zero_``), stage 11's cuDNN conv1, cuDNN's bf16 VALID conv at
            j's and j5's shapes (it writes y: it computes more)
15. train   the training path at full CNN2D width (180 features, 321
            frames, channels 1->32->64->128): the device EER against
            ``calculate_eer`` bit for bit (the golden cases of
            ``tests/test_eer.py``, two splits with tied minima of
            |FAR - FRR| and a seeded 200,000-row split with tied scores,
            n_spoof * n_bona > 2^31); ``python -m
            dfac_tpu_torch.cli.train`` with the reference's recipe flags at
            B=32 for 2 epochs on 1,024 train and 256 dev utterances, host-fed
            and ``--device-resident`` (exit 0, both checkpoints, epoch 2's
            train loss below epoch 1's); the trained checkpoint through
            ``evaluate --checkpoint`` (the EER ``fit`` recorded for its best
            epoch), ``predict`` and ``predict --fast`` (K2 f32, 3 launches
            per batch in process; scores within 1e-4 of each other);
            ``reproduce_reference --no-assert`` on a small fixture in the
            Zenodo layout (beside the two train runs); then ms per train step and utt/s at B=32 and
            B=512, host-fed and device-resident (median of 7 epochs, with
            min and max; no kernel of the port launched), a TF32-conv
            control and a channels-last control at B=512 (median of 3 each),
            and one profiled B=512 epoch: the device's
            busy share, its largest items, and conv1's forward and
            backward kernels
16. submission  the reference's submission path at full width (CNN2D and
            CNN1D 180 -> 32 -> 64 -> 128, the CAE at base 32, 321 x 180,
            weights from a seed with non-trivial BatchNorm statistics, a
            normalizer fitted on the bonafide half of a synthetic
            512-utterance labeled split, B=128): ``predict_scores_fast`` in
            bf16, the CNN2D leg of ``predict_hybrid --fast``, launches K2
            three times a batch and nothing else; the CNN1D and CAE fast
            chains (f32 and bf16, cuDNN, no kernel of the port) against their
            f32 eval models; ``predict_hybrid --fast`` against
            ``predict_hybrid`` (both ``--cnn-model`` values) within the bound
            its legs' differences give; then, as subprocesses on the split,
            ``predict --model cnn1d --fast``, ``train --model cnn1d`` (1
            epoch), ``evaluate_cae``, ``hybrid_ensemble``, ``ensemble
            cnn2d:... cnn1d:...``, ``predict_hybrid`` with and without
            ``--fast`` (concurrently), then ``generate_submission`` on the
            ``--fast`` prediction.pkl; then utt/s of the CNN1D chain (f32,
            bf16), the CAE chain (f32, bf16) and the two hybrid legs in
            sequence (K2 bf16 + the CAE in bf16) over 2,048 on-device feature
            tensors at B=128 (``chain_rates``: median of 7 with min and max),
            and one ``torch.profiler`` pass of the CAE and CNN1D chains
            (device ms a batch, busy share, the largest items)
17. alt-trainers  the reference's two other trainers at full width (the
            CAE at base 32 on 180 x 321 features, the detector at hidden 256
            on 180 channels and up to 321 frames; torch's init from a seed,
            synthetic train / dev / test2 splits of 512 / 128 / 128
            utterances with 160-321 valid frames): ``python -m
            dfac_tpu_torch.cli.train_cae --no-rich`` and ``... train_detector
            --ema --ema-decay 0.9 --specaug``, each host-fed and
            ``--device-resident``, 2
            epochs at B=32, all four at once (exit 0, their lines and
            artifacts; the two CAE runs' best validation MSE within 1e-3);
            the trained CAE through ``evaluate_cae`` (its EER as in process)
            and ``predict_hybrid --fast`` (against the fused legs in
            process, whose CNN2D leg launches K2 three times a batch and
            nothing else), the trained detector through ``train_detector
            --epochs 0`` plain, ``--fast`` (f32, atol 1e-4) and ``--fast
            --bf16`` (logits atol 2e-2); then ms per train step and utt/s of
            each trainer at B=32 and B=512, host-fed and device-resident
            (median of 7 epochs of 8 / 4 steps, with min and max; no kernel
            of the port launched), and one profiled B=512 resident epoch of
            each (device ms a step, busy share, the largest items)
18. zoo     every other model ``train`` accepts, bf16 training and the
            model-sweep CLIs at full width (the JAX defaults: the MLPs'
            hidden 128, the archived CNN1Ds 128/128/256, CNN2DSpatial and
            the CRNNs base 32 with a GRU of 128, CNN2DRobust base 64;
            torch's init from a seed; synthetic train / dev / test2 splits of
            256 / 128 / 128 utterances): fourteen CLIs at once, ``python -m
            dfac_tpu_torch.cli.train --no-rich`` for each of the 8 zoo
            models and ``--bf16`` for CNN2D and CNN1D (2 epochs at B=32: exit
            0, both checkpoints, each epoch's loss finite), ``train_detector
            --bf16``, ``compare_kernels --epochs 1`` (CNN1DVariant under the
            four default experiments: its table, its checkpoints' metadata),
            ``compare_normalization --epochs 1`` (its table) and ``benchmark
            --models cnn2d,crnn+specaug --seeds 0,1 --epochs 1`` (its three
            CSVs, its report, its plots where matplotlib is installed); then
            ``ensemble`` over the 11 trained checkpoints (the 8 zoo models,
            CNN1DVariant k5-3-3, CNN2D and CNN1D bf16) against each model's
            ``evaluate_classifier`` in process (each EER, the mean within
            1e-6) and ``predict --bf16`` against ``predict --fast --bf16`` on
            the bf16-trained CNN2D (2e-2); then ms per train step, f32 and
            device-resident, of each zoo model at B=32 and at B=512 or the
            largest power of two that fits (median of 7 epochs of 4 / 2
            steps, with min and max, every epoch's loss finite), f32 against
            bf16 at B=512 for CNN2D, CNN1D and the detector, one profile of
            the bf16 CNN2D step and one of the slowest zoo step (the
            in-process runs launch no kernel of the port; ``predict --fast
            --bf16`` runs K2 in its own process)
19. int8 + tools  w8a8 serving, int8 ingest and the data tools at full
            width (CNN2D and CNN1D 180 -> 32 -> 64 -> 128, weights from a
            seed with non-trivial BatchNorm statistics, a synthetic
            512-utterance split and its ``.npy`` store, B=128): in process,
            ``predict_scores_w8a8`` (1 ``block1_w8a8`` and 2
            ``conv_block_w8a8`` launches a batch and nothing else) and
            ``predict_scores_fast(ingest_int8=True)`` (3 K2 launches a batch)
            against the f32 ``--fast`` chain (5e-2); ``block1_w8a8`` against
            its plain version at the serving shape on the chain's transposed
            view (f32 bit for bit, bf16 within one code step at <= 0.1% of
            positions); ``conv_block_w8a8`` against its plain version bit for
            bit at both serving shapes (block 2 int8 pooled and block 3's
            mean over time, of a batch of the chain), block 3's f32 mode and
            an odd H; a second call of each equal; each block's ms in turns
            and on the device beside its bound (block 3's mean mode beside
            its f32 mode and that mode's bound), cuDNN's conv beside block 1
            and a ``torch._int_mm`` control over the 9-tap patch matrix
            beside blocks 2 and 3; utt/s of the w8a8 chain (f32, bf16)
            beside K2's f32 and bf16 chains over 2,048 on-device feature
            tensors (``chain_rates``: median of 7) and one profile of each
            w8a8 chain; anomaly embeddings on the card against the CPU eval
            model (256 utterances, 1e-4; the scikit-learn fits where it is
            installed); eleven CLIs at once: ``predict --fast`` with
            ``--int8``, ``--int8 --bf16``, ``--ingest-int8`` (cnn2d and
            cnn1d, on the store) and ``--int8 --ingest-int8`` (each within
            5e-2 of the f32 chain), the five ``data_tools`` subcommands
            (their lines; the bonafide store ``convert-to-npy --filter-label
            1`` writes) and ``train --profile-dir`` (1 epoch at B=32, a trace
            holding CUDA kernel events); then the host's ``quant_i8``
            against ``cast_bf16`` on a batch of 128 and ``predict_scores_fast``
            with int8 against bf16 ingest from a 2,048-utterance store, in
            turns
20. train-rest  the remainder of single-device training at full width
            (CNN2D 1 -> 32 -> 64 -> 128 on 180 x 321, the CAE at base 32, the
            detector at hidden 256; synthetic splits of 1,024 / 256 / 128
            utterances with 160-321 valid frames): six CLIs at once, 2 epochs
            at B=32 (``train --resident-chunk-batches 4 --chunk-ingest int8
            --train-fast``, ``train --fused-fit``, ``train_cae --fused-fit
            --train-fast``, ``train_cae --resident-chunk-batches 4
            --chunk-ingest bf16``, ``train_detector --fused-fit --train-fast
            --ema``, ``train_detector --resident-chunk-batches 4``: exit 0,
            their lines and artifacts), beside them in process ``fit_fused``
            against the per-epoch resident ``fit`` for CNN2D (plateau, early
            stop) and the detector (EMA, SpecAugment, patience) at B=32 for 3
            epochs with cuDNN's deterministic algorithms (the same best epoch,
            the histories within rel 1e-3, the best snapshot's BatchNorm
            statistics) and the freeze tail (epoch 3 of 3 at frac 0.5 leaves
            the statistics bit for bit, resident and chunked; a fused run
            frozen from the start keeps them at their init); then the
            chunk-trained CNN2D checkpoint served by ``predict_scores_fast``
            (K2 f32, 3 launches a batch) against ``predict_scores`` (1e-4);
            then, alone on the card, ms per step and utt/s of the chunked
            epoch (G=4) per ingest mode beside the resident epoch on the same
            orders at B=512 (4,096 utterances) and B=32 (1,024), median of 3
            epochs with min and max and the host-wait share
            (``PrefetchStats``), the f32 losses within rel 1e-3 of the
            resident ones; the wall time of ``fit_fused`` against ``fit``
            for 3 epochs at B=32 and B=512, in turns after a warm-up fit; a
            fused B=32 detector run traced (CUDA activity only) after three
            runs on the same trainer (busy share of its own wall, largest
            items)
21. data-parallel  ``--data-parallel`` training on the one card
            (``dfac_tpu_torch/parallel``): in this process, a one-rank NCCL
            group runs the data-parallel trainer at full CNN2D width (its
            eager synced BatchNorm, the flat gradient all-reduce, rank 0's
            broadcast decisions): a 2-epoch fit at B=32 on 1,024 / 256
            utterances against the single-device host-fed fit on the same
            order (cuDNN deterministic; losses rel 1e-3, the same best
            epoch), ms per step of the two at B=512 and B=32 in turns
            (single, DP, DP, single; median of 2 epochs of 4 / 8 steps each
            turn), and the DP-trained checkpoint through ``predict --fast``'s
            K2 f32 chain (3 launches a batch) against ``predict_scores``
            (1e-4); two gloo ranks sharing the card take one CNN2D DP step at
            a global B=64 against the single-device step on the
            concatenated batch (SGD 0.1, ``tests/test_parallel.py:60``'s
            tolerances: the loss sum rtol 1e-5, parameters atol 2e-6,
            BatchNorm mean atol 1e-6 and var rtol 1e-4); ``train
            --data-parallel 2`` exits non-zero with ``make_mesh``'s
            device-count message
22. multihost  multi-host training and sharded serving on the one card
            (``dfac_tpu_torch/parallel/multihost.py``, ``serving.py``): two
            gloo ranks sharing the card score 1,024 waveforms of 51,520
            samples at global B=128 through the sharded fast corpus scorer
            (K1 + K2 bf16, full CNN2D width, weights from a seed) and 1,024
            feature tensors through ``predict --fast --data-parallel``'s f32
            loop, each against the single-device chain (bit for bit, else
            one bf16 last bit / 1e-6), K1 8 and K2 24 launches a rank, and
            each rate beside the single-device one (two processes on one
            card: not scale-out); then 18 CLIs at once, each reporting its
            kernel launches: ``predict --fast --multihost --num-processes
            2`` pairs in f32, ``--bf16`` and ``--ingest-int8`` (process 0's
            file against ``predict --fast`` on one device, 3 K2 launches a
            batch in each process, process 1 writing nothing), a
            ``predict_hybrid --fast --multihost`` pair against one
            ``predict_hybrid --fast``, ``predict --fast --multihost
            --num-processes 1`` (world 1 over NCCL), ``train --multihost``
            pairs host-fed and ``--fused-fit`` (CNN2D full width, 1,024 /
            256 utterances from ``.npy`` stores, B=32, 2 epochs, cuDNN
            deterministic) against a two-rank ``RankPool`` DP fit run beside
            them (the same best epoch, weights and state within 1e-3; they
            were equal), ``train_cae`` and ``train_detector --multihost``
            pairs (1 epoch; process 0 alone writes); the multi-host-trained
            checkpoint through K2 f32 against ``predict_scores``

The last three lines are the card's name and power limit, a JSON object
with one entry per kernel (K1 and K2 twice: ``gemm_frontend`` and
``conv_block`` are their bf16 modes on the slice, ``gemm_frontend_f32`` K1's
f32 mode on the ``gemm`` extraction, ``conv_block_f32`` K2's on ``predict
--fast``'s f32 chain; ``conv_block_w8a8`` and ``block1_w8a8`` (its f32
mode, the main path's run), phase 19's int8 chain, have no Pallas
counterpart; for ``conv_block``, ``conv_block_f32``, ``time_pool``,
``conv_probe``, ``conv1_pass``, ``conv_forms``, ``conv_chunked``,
``conv_trailing`` and ``conv_block_w8a8``, ``ms``, ``plain_ms``,
``library_ms`` and ``bound_ms`` are sums over the shapes or cases of one
batch) and ``{"ok": true, "device": {...}}``. ``bound_ms`` is the least time the card could take for the same
work: the larger of the bytes each call must move (inputs read once,
outputs written once) over 3.35 TB/s and its operations of each type over
the dense peak for that type (989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s f32 on the CUDA cores, 1,979 TOP/s int8 on the tensor cores;
NVIDIA's H100 SXM data sheet; the two units run at once, so the larger
time counts). A probe case's operations count
at the rate of the unit it runs on: v1 and d (and v0) on the CUDA cores at
the f32 rate, with their bf16-rate bound printed beside it; the rest on the
tensor cores. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
START = time.perf_counter()
SEED = 0
BATCH = 128
N_FRAMES = 321
CORPUS = 8192
F32_CORPUS = 2048  # feature tensors per timed run of predict --fast's f32 chain
CLI_UTTS = 512
EXTRACT_BATCH = 64  # the extraction CLI's default
EXTRACT_UTTS = 512
EXTRACT_CORPUS = 2048  # utterances per timed extraction run
PROBE_BATCH = 512  # the probes' default batch
POOL_SHAPES = [(PROBE_BATCH, 321, 180, 32), (PROBE_BATCH, 160, 180, 64)]  # the pool probe's two pools
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}  # dense, H100 SXM (int8: operations a second)

# tolerances, with their reasons
K1_ATOL, K1_RTOL = 1e-3, 1e-3  # same operands; only the f32 summation order of
# the K=320 DFT and the 120-term DCT differs, and log() amplifies relative error
# of the smallest energies
K2_RTOL, K2_ATOL = 2.0**-7, 1e-4  # one bf16 last bit: kernel and plain round
# f32 sums taken in different orders, which can straddle a rounding boundary
K2_F32_TOL = 1e-4  # f32 mode, atol and rtol: summation order only (the cuda tests' f32 bound)
F32_SCORE_ATOL = 1e-4  # f32 chain against the f32 model: BN folded and sums in other
# orders (the CPU tests hold the chain to 1e-5 at small widths)
SCORE_ATOL = 2e-2  # sigmoid scores of two bf16 chains, as tests/test_conv_block.py:45
K4_ATOL, K4_RTOL = 1e-4, 1e-4  # same f32 operands and math; only the summation
# order differs (dense cuBLAS products against the kernel's banded, in-order
# sums): the JAX package's bound for its kernel against XLA, tests/test_lfcc.py:112.
# The deltas are sums of five terms with |weights| summing to 0.6, so they stay
# inside the same bound
METHOD_ATOL, METHOD_RTOL = 5e-3, 1e-3  # direct DFT against FFT: the JAX package's
# bound, tests/test_torch_port_frontend.py:105-109
CHECKSUM_RTOL = 1e-5  # conv-probe checksums: bf16 x bf16 products are exact in
# f32, so kernel and plain differ only by f32 summation order; bound relative
# to the sample's sum |y|
Y_ATOL, Y_RTOL = 1e-4, 1e-5  # every y of the conv cases (conv1_checksum, conv1_tc, conv2_checksum): exact
# products, f32 sums of 9 (conv1), 288 or 576 terms in another order (the cuda tests' bound)
FMA_CASES = ("v1", "d")  # the probe cases on the CUDA cores (conv1_checksum): bound at the f32 rate
# K7, K8, K10, K11 -> their train_opt_probe stage
PASS_KERNELS = {"conv1_pass": "11", "conv_forms": "12", "conv_chunked": "14", "conv_trailing": "15"}
# the training phase (15)
TRAIN_FEATURES = 180  # CNN2D's full width (the LFCC+delta+delta-delta features)
TRAIN_UTTS, TRAIN_DEV_UTTS = 1024, 256  # the CLI runs' corpus
TRAIN_BATCH, TRAIN_BIG_BATCH = 32, 512  # the reference recipe's batch; the probes' batch
TRAIN_STEPS = {TRAIN_BATCH: 8, TRAIN_BIG_BATCH: 4}  # steps per timed epoch
EER_ROWS = 200_000
CAE_RTOL = {"float32": 1e-4, "bfloat16": 0.1}  # CAE MSE against the f32 eval model: the JAX package's
# bounds, tests/test_fast_infer.py:205-207 (f32: BN folded, sums in another order; bf16 activations)
REPRO_UTTS = {"train": 64, "dev": 32, "test1": 16}
RECIPE = ["--spec-augment", "--time-mask-ratio", "0.20", "--feature-mask", "--feature-mask-ratio", "0.10",
          "--time-shift", "--time-shift-ratio", "0.10", "--channel-drop", "--channel-drop-prob", "0.05",
          "--gaussian-jitter", "--gaussian-jitter-std", "0.005", "--label-smoothing", "0.05",
          "--lr-scheduler", "plateau", "--lr-scheduler-metric", "dev_eer"]  # the reference's robust recipe
# the alternative trainers' phase (17)
ALT_UTTS = {"train": 512, "dev": 128, "test2": 128}  # the CLI runs' corpus, in the detector's split layout
ALT_MIN_FRAMES = 160  # the detector corpus's utterances hold 160..321 valid frames
DETECTOR_HIDDEN, CAE_BASE = 256, 32  # the reference's widths
DETECTOR_BF16_ATOL = 2e-2  # logits of the bf16 folded chain against the f32 eval model
# the zoo's phase (18)
ZOO = ("meanpool_mlp", "statspool_mlp", "cnn1d_spatial", "cnn1d_archive", "cnn2d_spatial", "crnn", "crnn2",
       "cnn2d_robust")  # the archived zoo at the JAX defaults' widths; cnn1d_variant trains under compare_kernels
ZOO_UTTS = {"train": 256, "dev": 128, "test2": 128}  # the CLI runs' corpus
ZOO_STEPS = {TRAIN_BATCH: 4, TRAIN_BIG_BATCH: 2}  # steps per timed epoch of each zoo model
ENSEMBLE_ATOL = 1e-6  # the ensemble CLI's mean against the in-process evaluate_classifier scores: same f32 model,
# same batch shape (cuDNN's choice of algorithm repeats), so only the host-side mean's order may differ
# the int8 and tools phase (19)
W8A8_SCORE_ATOL = 5e-2  # w8a8 and int8-ingest scores against the f32 --fast chain: the JAX package's bound for
# int8 weights and activations, tests/test_fast_infer_int8.py
W8A8_PER_BATCH = {"block1_w8a8": 1, "conv_block_w8a8": 2}  # the w8a8 chain's kernel launches a batch
W8A8_MAX_MOVED = 1e-3  # bf16 block 1 against its plain version: the tensor cores' sums may move a code by one step
# at <= 0.1% of positions (tests/test_torch_port_int8.py's bound against JAX)
EMBED_ATOL = 1e-4  # anomaly embeddings on the card against the CPU eval model: f32 convs, sums in other orders
EMBED_UTTS = 256
INT8_TRAIN_UTTS = 128  # train --profile-dir's train and dev splits
INT8_STORE_UTTS = 2048  # the store of the ingest comparison
PREDICT_INT8 = {  # predict --fast's int8 variants: label -> (model, on the .npy store, flags)
    "--int8": ("cnn2d", False, ["--int8"]),
    "--int8 --bf16": ("cnn2d", False, ["--int8", "--bf16"]),
    "--ingest-int8": ("cnn2d", True, ["--ingest-int8"]),
    "--model cnn1d --ingest-int8": ("cnn1d", True, ["--ingest-int8"]),
    "--int8 --ingest-int8": ("cnn2d", True, ["--int8", "--ingest-int8"]),
}
# the remainder of single-device training (20)
REST_UTTS, REST_BIG_BATCH, REST_CHUNK = 4096, 512, 4  # the chunked epoch at B=512: 8 batches in 2 chunks of G=4
REST_SMALL_UTTS = 1024  # the chunked epoch at B=32: 32 batches in 8 chunks
REST_CLI_UTTS = {"train": 1024, "dev": 256, "test2": 128}  # the CLIs' and the B=32 fused fits' corpus
REST_FUSED_BIG_UTTS = 2048  # the fused and per-epoch fits at B=512: 4 steps an epoch
REST_EPOCHS, REST_REPS = 3, 3  # epochs of a fused / per-epoch fit; timed epochs of a chunked feed
REST_RTOL = 1e-3  # card runs of one computation in two feeds (cuDNN need not be deterministic)
# data-parallel training (21)
DP_STEP_BATCH = 64  # the two ranks' global batch: 32 rows a rank
DP_REPS = 2  # timed epochs per turn
DP_TIMEOUT_S = 300  # a collective that waits longer fails its rank
DP_CLI_UTTS = 16
# the multi-host phase (22)
MH_UTTS = 1024  # waveforms (and feature tensors) the two ranks' sharded scorers take, at global B=BATCH
MH_CLI_UTTS = 512  # the serving CLIs' corpus
MH_DETECTOR_UTTS = {"train": 256, "dev": 64, "test2": 64}  # train_detector's splits (the others train on TRAIN_UTTS)
MH_RATE_REPS = 3  # timed runs of each rate
MH_TIMEOUT_S = 300  # a collective or a CLI that waits longer fails the phase
MH_CLI = ("import importlib, json, sys, torch; torch.backends.cudnn.deterministic = True; "
          "from dfac_tpu_torch.ops import _build; importlib.import_module(sys.argv[1]).main(sys.argv[2:]); "
          "print('launches ' + json.dumps(_build.launch_counts()))")  # a CLI run that reports its kernel launches
PASS_REPLACES = {"conv1_pass": "scripts/train_opt_probe.py:845", "conv_forms": "scripts/train_opt_probe.py:974",
                 "conv_chunked": "scripts/train_opt_probe.py:1248", "conv_trailing": "scripts/train_opt_probe.py:1355"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout
    return out.strip().splitlines()[0]


def require(ok, msg) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(msg)


def phase(name: str, msg: str) -> None:
    print(f"[{name} {time.perf_counter() - START:.1f}s] {msg}", flush=True)


def max_errors(got, want):
    d = (got.float() - want.float()).abs()
    rel = d / want.float().abs().clamp_min(1e-6)
    return d.max().item(), rel.max().item()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PROFILER_TRIES = 3  # torch.profiler passes before device_ms falls back to queued CUDA events


def queued_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` over ``reps`` calls queued behind a
    spin kernel (``torch.cuda._sleep``): the host enqueues every launch
    while the stream is held, so CUDA events around them time the device
    alone, without the wrappers' host work. The spin is lengthened until
    it outlasts the enqueueing."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # ~10 ms at the H100's boost clock
    for _ in range(4):
        held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        held.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < 0.8 * held.elapsed_time(start):
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError(f"queued_ms: enqueueing {reps} calls outlasted a spin of {cycles // 4} cycles")


def device_ms(fn, kernel: str, reps: int = 10) -> tuple[float, str]:
    """(device time per launch, how it was taken) of the kernel named
    ``kernel`` over ``reps`` calls of ``fn``: from ``torch.profiler``'s
    kernel records (``dfac_tpu_torch.profiling.kernel_device_ms``), the
    kernel alone without its wrapper's host work, failing where a pass holds
    more launches than calls. A pass that holds fewer is retried (the
    profiler has been seen to drop every device record of a pass, and half
    of them); where no pass of ``PROFILER_TRIES`` kept one record a call,
    :func:`queued_ms` takes the device time instead."""
    from dfac_tpu_torch.profiling import kernel_device_ms

    for _ in range(PROFILER_TRIES):
        found = kernel_device_ms(fn, kernel, reps)
        if found is None:
            continue
        require(found[1] <= reps, f"torch.profiler: {found[1]} {kernel} launches over {reps} calls")
        if found[1] == reps:
            return found[0], "torch.profiler"
        print(f"torch.profiler kept {found[1]} of {reps} {kernel} records in a pass", file=sys.stderr, flush=True)
    print(f"torch.profiler kept no full pass of {kernel} records in {PROFILER_TRIES} passes: CUDA events over "
          f"{reps} launches queued behind a spin kernel instead", file=sys.stderr, flush=True)
    return queued_ms(fn, reps), "CUDA events, queued launches"


def bound(n_bytes: float, **flops: float) -> tuple[float, str]:
    """(ms, limiter): the largest of ``n_bytes`` over the HBM rate and the
    operations of each type over its peak rate (``bf16=``, ``f32=``, ``int8=``; the
    tensor cores and the CUDA cores work at the same time)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max((n / PEAK_FLOPS[kind] for kind, n in flops.items()), default=0.0)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bound_sum(parts) -> tuple[float, str]:
    """Bounds of the shapes of one entry, summed; the limiter of the larger share."""
    by = {"bytes": 0.0, "operations": 0.0}
    for ms, limiter in parts:
        by[limiter] += ms
    return sum(by.values()), max(by, key=by.get)


def conv_pass_work(name: str, a, wt) -> tuple[int, int]:
    """(multiply-adds, bytes of the result) of one call of stage 11/12's case
    ``name`` on input ``a`` and weights ``wt``, from their shapes."""
    from dfac_tpu_torch.ops import conv_probe

    b, sums = a.shape[0], 8 * 128 * 4  # a checksum's (8, 128) f32 block per result
    if name == "f":  # every output pixel of the pre-padded h1 against all 9 x 32 x 64 weights
        return b * (a.shape[1] - 2) * (a.shape[2] - 2) * wt.numel(), b * sums
    if name == "c":  # M = Np - 2W outputs per sample
        return b * (a.shape[-1] - 2 * conv_probe.FLAT_WIDTH) * wt.numel(), b * sums
    t, f = a.shape[1:]
    pixels = {"v0": 0, "v1": b * t * f, "v2": b * t * f, "v3": b // 8 * 8 * t * f, "v4": b * (t // 2 * 2) * f,
              "a": b * (t - 2) * (f - 2), "d": b * (t - 2) * (f - 2)}[name]
    out_bytes = {"v3": b // 8 * sums, "v4": b * (t // 2) * f * wt.shape[-1] * 2}.get(name, b * sums)
    return pixels * wt.numel(), out_bytes  # 9 taps x CO weights per output pixel


def chunk_work(name: str, a, wt) -> tuple[int, int]:
    """(multiply-adds, input elements the result depends on) of one call of
    stage 14/15's case ``name`` on input ``a`` and weights ``wt``."""
    from dfac_tpu_torch.ops import conv_probe as cp

    b = a.shape[0]
    if name == "c2":  # row 0 of xf alone; taps 9-15 are zero and add nothing
        return b * cp.CHUNKS * cp.CHUNK_LEN * 9 * wt.shape[0], b * a.shape[-1]
    if name == "i2":  # the planes' rows t < CONV1_ROWS
        return b * cp.CONV1_ROWS * a.shape[-1] * wt.numel(), a[:, :, : cp.CONV1_ROWS].numel()
    if name == "h2":  # rows t + dy, the columns of the windows
        read = set().union(*(range(s, s + cp.H2_WINDOW + 2) for s in cp.h2_col_starts(a.shape[2])))
        return b * cp.CONV1_ROWS * cp.H2_WINDOWS * cp.H2_WINDOW * wt.numel(), b * (cp.CONV1_ROWS + 2) * len(read)
    rows, cols = (cp.CONV3_ROWS, cp.CONV3_COLS) if name == "j5" else (cp.CONV2_ROWS, cp.CONV2_SLICE_COLS)
    return b * rows * cols * wt.numel(), a[:, : rows + 2, : cols + 2].numel()  # j2-j4: w2 or w2i, 9 x 32 x 64


def in_turns(plain, kernel, reps: int = 10):
    """plain, kernel, kernel, plain after a warm-up of each; returns the mean
    ms of the kernel and of the plain version."""
    plain(), kernel()
    p1, k1, k2, p2 = (cuda_ms(f, reps) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def check_units(lib_path: str) -> None:
    """From the built library's SASS: the CUDA-core conv1 (``conv1_checksum``,
    v1 and d) issues no tensor-core instruction, and v4's ``conv1_emit`` does
    (``HMMA``); prints each one's count of FFMA, FADD, shared loads and
    tensor-core instructions."""
    from dfac_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], check=True, capture_output=True, text=True).stdout
    found = set()
    for chunk in re.split(r"^\s*Function : ", sass, flags=re.M)[1:]:
        fn = chunk.split(None, 1)[0]
        kernel = next((k for k in ("conv1_checksum", "conv1_emit") if k in fn), None)
        if kernel is None:
            continue
        ops = re.findall(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", chunk, flags=re.M)
        count = {op: ops.count(op) for op in ("FFMA", "FADD", "LDS", "HMMA", "HGMMA")}
        tensor = count["HMMA"] + count["HGMMA"]
        phase("build", f"SASS {fn}: {len(ops)} instructions, " + ", ".join(f"{k} {v}" for k, v in count.items()))
        if (kernel == "conv1_checksum") == bool(tensor):
            raise AssertionError(f"{fn}: {tensor} tensor-core instructions; want "
                                 f"{'none' if kernel == 'conv1_checksum' else 'HMMA'}")
        found.add(kernel)
    if found != {"conv1_checksum", "conv1_emit"}:
        raise AssertionError(f"SASS: found {sorted(found)} of conv1_checksum, conv1_emit")


def eer_golden() -> list:
    """(scores, labels) of the golden cases of ``tests/test_eer.py``."""
    rng = np.random.default_rng(42)
    labels = (rng.random(200) > 0.5).astype(int)
    scores = rng.normal(size=200) + labels * 1.5
    return [
        (np.array([0.1, 0.2, 0.3, 0.8, 0.9, 0.95]), np.array([0, 0, 0, 1, 1, 1])),
        (np.array([0.1, 0.85, 0.3, 0.8, 0.2, 0.95]), np.array([0, 0, 0, 1, 1, 1])),
        (scores, labels),
        (1 - scores, labels),
        (np.array([0.1, 0.2]), np.array([1, 1])),
        (np.array([0.5, 0.5, 0.5, 0.5, 0.7, 0.7]), np.array([0, 1, 0, 1, 0, 1])),
    ]


def eer_tied_minima() -> list:
    """Splits whose |FAR - FRR| has two minimal positions: exactly equal, or
    equal until float64 rounds them apart (``tests/test_torch_port_train.py``)."""
    return [(np.array([0.1, 0.2, 0.3], np.float32), np.array([1, 0, 1])),
            (np.array([0, 2, 5, 1, 3, 2, 2, 0, 1], np.float32), np.array([0, 1, 0, 0, 0, 0, 1, 0, 1]))]


def write_split(root: str, name: str, ds, labeled: bool = True) -> tuple[str, str]:
    """A split as the reference's pickles (torch.Tensor cells) under
    ``root/name``; where ``ds`` has lengths, each cell holds its valid frames."""
    import pandas as pd
    import torch

    d = os.path.join(root, name)
    os.makedirs(d)
    fpath, lpath = os.path.join(d, "features.pkl"), os.path.join(d, "labels.pkl")
    lengths = ds.lengths if ds.lengths is not None else [ds.features.shape[2]] * len(ds)
    cells = [torch.from_numpy(np.ascontiguousarray(m[:, :n])) for m, n in zip(ds.features, lengths)]
    pd.DataFrame({"uttid": ds.uttids, "features": cells}).to_pickle(fpath)
    if labeled:
        pd.DataFrame({"uttid": ds.uttids, "label": ds.labels.astype(np.int64)}).to_pickle(lpath)
    return fpath, lpath


def run_all(commands: dict, env) -> dict:
    """Start every command at once; wait for all; stdout of each, or fail
    with the first non-zero exit and its stderr."""
    return finish_all(start_all(commands, env))


def start_all(commands: dict, env) -> dict:
    """Start every command at once (:func:`finish_all` collects them)."""
    return {k: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
            for k, cmd in commands.items()}


def finish_all(procs: dict) -> dict:
    """Wait for every process of :func:`start_all`; stdout of each, or fail
    with the first non-zero exit and its stderr."""
    outs = {k: p.communicate() for k, p in procs.items()}
    for k, p in procs.items():
        if p.returncode != 0:
            raise AssertionError(f"{k} exited {p.returncode}: {outs[k][1][-3000:]}")
    return {k: out for k, (out, _) in outs.items()}


def epoch_losses(out: str) -> list[float]:
    """The train losses of the train CLI's ``--no-rich`` epoch lines (the tqdm display)."""
    return [float(m.group(1)) for m in re.finditer(r"^Epoch \d+: train_loss=(\S+)", out, re.M)]


def train_phase(dev, card: str) -> None:
    """Phase 15: the training path at full width (see the module docstring)."""
    import contextlib

    import pandas as pd
    import torch

    from dfac_tpu_torch.data.augment import AugmentConfig
    from dfac_tpu_torch.models.fast_infer import predict_scores_fast
    from dfac_tpu_torch.ops import _build
    from dfac_tpu_torch.ops import eer as teer
    from dfac_tpu_torch.train import loop as train_loop
    from dfac_tpu_torch.train import rates
    from dfac_tpu_torch.train.checkpoint import load_checkpoint, load_model_variables
    from dfac_tpu_torch.train.evaluate import predict_scores
    from dfac_tpu_torch.models import build_model

    features = TRAIN_FEATURES
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    # -- device EER, bit for bit
    for scores, labels in eer_golden() + eer_tied_minima():
        want = teer.calculate_eer(scores, labels)
        s_dev, l_dev = torch.as_tensor(scores, device=dev), torch.as_tensor(labels, device=dev)
        got, got_t = teer.eer_device(s_dev, l_dev), tuple(float(v) for v in teer.eer_torch(s_dev, l_dev))
        require(got == want == got_t, f"eer_device {got}, eer_torch {got_t}, calculate_eer {want}")
    rng = np.random.default_rng(SEED)
    labels = (rng.random(EER_ROWS) > 0.5).astype(np.int64)
    scores = (np.round((rng.normal(size=EER_ROWS) + labels) * 64) / 64).astype(np.float32)  # ties
    n_bona = int(labels.sum())
    n_spoof = EER_ROWS - n_bona
    require(n_bona * n_spoof > 2**31, "the split must overflow int32 products")
    t0 = time.perf_counter()
    want = teer.calculate_eer(scores, labels)
    host_ms = (time.perf_counter() - t0) * 1e3
    s_dev, l_dev = torch.from_numpy(scores).to(dev), torch.from_numpy(labels).to(dev)
    teer.eer_device(s_dev, l_dev)
    sync()
    t0 = time.perf_counter()
    got = teer.eer_device(s_dev, l_dev)
    dev_ms = (time.perf_counter() - t0) * 1e3
    got_t = tuple(float(v) for v in teer.eer_torch(s_dev, l_dev))
    require(got == want == got_t, f"eer_device {got}, eer_torch {got_t}, calculate_eer {want}")
    phase("train", f"eer_device and eer_torch on {card}: the {len(eer_golden())} golden cases, "
                   f"{len(eer_tied_minima())} tied minima and {EER_ROWS} rows "
                   f"({EER_ROWS - len(np.unique(scores))} tied scores, n_spoof * n_bona = {n_spoof * n_bona:,} > "
                   f"2^31) equal calculate_eer bit for bit: eer {got[0]!r}, threshold {got[1]!r}; eer_device "
                   f"{dev_ms:.2f} ms, calculate_eer {host_ms:.2f} ms on the host")

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cli = [sys.executable, "-m"]
    with tempfile.TemporaryDirectory(prefix="dfac_smoke_train_") as tmp:
        # -- the train CLI, host-fed and device-resident, at the recipe's batch
        train_ds = rates.synthetic_dataset(TRAIN_UTTS, features, N_FRAMES, 1)
        dev_ds = rates.synthetic_dataset(TRAIN_DEV_UTTS, features, N_FRAMES, 2)
        (tf, tl), (df, dl) = write_split(tmp, "train", train_ds), write_split(tmp, "dev", dev_ds)
        data = os.path.join(tmp, "data")  # reproduce_reference's fixture in the Zenodo layout
        for i, (name, n) in enumerate(REPRO_UTTS.items()):
            write_split(data, name, rates.synthetic_dataset(n, features, N_FRAMES, 10 + i), labeled=name != "test1")
        out_dir = os.path.join(tmp, "repro")
        ck = os.path.join(tmp, "ck")
        base = [*cli, "dfac_tpu_torch.cli.train", "--train-features", tf, "--train-labels", tl, "--dev-features", df,
                "--dev-labels", dl, "--batch-size", str(TRAIN_BATCH), "--epochs", "2", "--checkpoint-dir", ck,
                "--seed", str(SEED), "--in-features", str(features), "--device", dev.type, "--no-rich", *RECIPE]
        t0 = time.perf_counter()
        outs = run_all({"host-fed": base + ["--run-name", "host"],
                        "device-resident": base + ["--run-name", "resident", "--device-resident"],
                        "reproduce_reference": [*cli, "dfac_tpu_torch.cli.reproduce_reference", "--data-dir", data,
                                                "--out-dir", out_dir, "--epochs", "1", "--batch-size",
                                                str(TRAIN_BATCH), "--no-assert", "--device", dev.type]}, env)
        phase("train", f"train CLI x2 and reproduce_reference (concurrent): {time.perf_counter() - t0:.1f}s")
        require(os.path.exists(os.path.join(out_dir, "report.md")) and
                len(pd.read_pickle(os.path.join(out_dir, "prediction.pkl"))) == REPRO_UTTS["test1"], "no report")
        for line in outs.pop("reproduce_reference").strip().splitlines():
            if line.startswith("|") or "wrote" in line:
                phase("train", f"reproduce_reference --no-assert: {line}")
        for label, out in outs.items():
            for line in out.strip().splitlines():
                phase("train", f"cli {label}: {line}")
            losses = epoch_losses(out)
            require(len(losses) == 2 and losses[1] < losses[0], f"{label}: epoch train losses {losses}")
            run_dir = os.path.join(ck, "host" if label == "host-fed" else "resident")
            for kind in ("best", "last"):
                require(os.path.exists(os.path.join(run_dir, f"cnn2d_{kind}.ckpt")), f"{label}: no {kind} checkpoint")

        # -- serve and evaluate the host-fed run's best checkpoint
        best = os.path.join(ck, "host", "cnn2d_best.ckpt")
        best_eer = load_checkpoint(best)["config"]["_trainer_state"]["best_eer"]
        preds = {k: os.path.join(tmp, f"{k}.pkl") for k in ("eval-model", "fast")}
        pred = [*cli, "dfac_tpu_torch.cli.predict", "--features", df, "--checkpoint", best, "--model", "cnn2d",
                "--batch-size", str(BATCH), "--in-features", str(features), "--device", dev.type]
        t0 = time.perf_counter()
        outs = run_all({
            "evaluate": [*cli, "dfac_tpu_torch.cli.evaluate", "--features", df, "--labels", dl, "--checkpoint", best,
                         "--batch-size", str(TRAIN_BATCH), "--no-apply-sigmoid", "--in-features", str(features),
                         "--device", dev.type],
            "predict": pred + ["--out", preds["eval-model"]],
            "predict --fast": pred + ["--out", preds["fast"], "--fast"],
        }, env)
        phase("train", f"evaluate and predict x2 (concurrent): {time.perf_counter() - t0:.1f}s")
        for label, out in outs.items():
            for line in out.strip().splitlines():
                phase("train", f"{label}: {line}")
        eer = float(re.search(r"^eer=(\S+)", outs["evaluate"], re.M).group(1))
        require(eer == best_eer, f"evaluate --checkpoint: eer {eer!r}; fit's best epoch: {best_eer!r}")
        cli_scores = {k: pd.read_pickle(v)["predictions"].to_numpy() for k, v in preds.items()}
        d_cli = float(np.abs(cli_scores["eval-model"] - cli_scores["fast"]).max())
        model = build_model("cnn2d", in_features=features)
        model.load_state_dict(load_model_variables(best))
        _build.reset_launch_counts()
        fast = predict_scores_fast(model.state_dict(), dev_ds, dev, batch_size=BATCH, compute_dtype=torch.float32)
        served = _build.launch_counts()
        n_served = -(-TRAIN_DEV_UTTS // BATCH)
        require(served == {**dict.fromkeys(served, 0), "conv_block": 3 * n_served}, f"served: {served}")
        plain = predict_scores(model.to(dev), dev_ds, batch_size=BATCH, apply_sigmoid=True)
        d_in = float(np.abs(fast - plain).max())
        d_fast = float(np.abs(fast - cli_scores["fast"]).max())
        phase("train", f"evaluate --checkpoint eer {eer!r} = fit's best epoch {best_eer!r}; predict vs predict --fast "
                       f"(K2 f32) on {TRAIN_DEV_UTTS} utterances: max abs {d_cli:.3e}; in process {d_in:.3e}, "
                       f"launches over {n_served} batches {served}; predict_scores_fast vs the CLI's --fast "
                       f"{d_fast:.3e} (tolerance {F32_SCORE_ATOL})")
        require(max(d_cli, d_in, d_fast) <= F32_SCORE_ATOL, "predict and predict --fast disagree")


    # -- ms per step and utt/s, host-fed and device-resident; one profiled epoch
    recipe = AugmentConfig(spec_augment=True, time_mask_ratio=0.2, feature_mask=True, feature_mask_ratio=0.1,
                           time_shift=True, time_shift_ratio=0.1, channel_drop=True, channel_drop_prob=0.05,
                           gaussian_jitter=True, gaussian_jitter_std=0.005)
    _build.reset_launch_counts()
    for b, steps in TRAIN_STEPS.items():
        ds = rates.synthetic_dataset(b * steps, features, N_FRAMES, 3)
        for resident in (False, True):
            cfg = train_loop.TrainConfig(batch_size=b, in_features=features, seed=SEED, label_smoothing=0.05,
                                         augment=recipe,
                                         lr_scheduler="plateau", device_resident=resident)
            trainer = train_loop.Trainer(cfg, device=dev)
            trainer.init_state()
            secs = rates.epoch_seconds(trainer, ds)
            ms = [1e3 * t / steps for t in secs]
            utt = [len(ds) / t for t in secs]
            phase("train", f"train step B={b} {'device-resident' if resident else 'host-fed'}: "
                           f"{statistics.median(ms):.4f} ms (median of {len(ms)} epochs of {steps} steps; min "
                           f"{min(ms):.4f}, max {max(ms):.4f}), {statistics.median(utt):.1f} utt/s (min {min(utt):.1f}, "
                           f"max {max(utt):.1f}), f32 convs, on {card}")
        if b != TRAIN_BIG_BATCH:
            continue
        prof = rates.profile_epoch(trainer, ds, 100, (b, 1, N_FRAMES, features))
        dev_share = (lambda t: t / prof["device_ms"]) if prof["device_ms"] else (lambda t: float("nan"))
        phase("train", f"profile B={b} device-resident: device {prof['device_ms']:.4f} ms a step, busy "
                       f"{prof['device_ms'] / statistics.median(ms):.1%} of the {statistics.median(ms):.4f} ms step "
                       f"(profiled wall {prof['wall_ms']:.4f} ms)")
        for name, k_ms, n in prof["top"]:
            phase("train", f"  {k_ms:8.4f} ms {dev_share(k_ms):6.1%} {n:5.1f}x  {name[:110]}")
        conv1 = prof["conv"]
        require(conv1["ops"]["forward"] == conv1["ops"]["backward"] == steps, f"conv1 ops per epoch: {conv1['ops']}")
        for kind in ("forward", "backward"):
            total = sum(k_ms for k_ms, _ in conv1[kind].values())
            phase("train", f"conv1 {kind} (cuDNN, input ({b}, 1, {N_FRAMES}, {features})): {total:.4f} ms a step, "
                           f"{dev_share(total):.1%} of the device time")
            for name, (k_ms, n) in sorted(conv1[kind].items(), key=lambda kv: -kv[1][0]):
                phase("train", f"  {k_ms:8.4f} ms {n:4.1f}x  {name[:110]}")
        dgrad = [name for name in conv1["backward"] if "dgrad" in name.lower()]
        phase("train", f"conv1 data grad: {dgrad or 'no kernel (its input needs no gradient)'}")
        # control: the same step with cuDNN's TF32 convs (torch's default for f32 on Hopper)
        torch.backends.cudnn.allow_tf32 = True
        train_loop.f32_convs = contextlib.nullcontext
        try:
            ms_tf32 = [1e3 * t / steps for t in rates.epoch_seconds(trainer, ds, reps=3, first_epoch=200)]
        finally:
            train_loop.f32_convs = sys.modules["dfac_tpu_torch.models.common"].f32_convs
            torch.backends.cudnn.allow_tf32 = False
        phase("train", f"control, train step B={b} device-resident with TF32 convs: {statistics.median(ms_tf32):.4f} ms "
                       f"(median of {len(ms_tf32)} epochs; min {min(ms_tf32):.4f}, max {max(ms_tf32):.4f}), on {card}")
        # control: the same step with the model channels-last (NHWC activations for BatchNorm and the pools)
        trainer.model.to(memory_format=torch.channels_last)
        try:
            ms_nhwc = [1e3 * t / steps for t in rates.epoch_seconds(trainer, ds, reps=3, first_epoch=300)]
        finally:
            trainer.model.to(memory_format=torch.contiguous_format)
        phase("train", f"control, train step B={b} device-resident with the model channels-last (f32 convs): "
                       f"{statistics.median(ms_nhwc):.4f} ms (median of {len(ms_nhwc)} epochs; min {min(ms_nhwc):.4f}, "
                       f"max {max(ms_nhwc):.4f}), on {card}")
    trained = _build.launch_counts()
    require(not any(trained.values()), f"training launched kernels of the port: {trained}")
    phase("train", f"launches over the timed training runs: {trained} (cuDNN and cuBLAS only)")


def fused_bound(alpha: float, legs_a, legs_b) -> float:
    """The most two fusions (``ensemble.hybrid.fuse_scores``) of legs that
    differ by ``d`` (max abs, per leg) can differ: min-max normalization
    moves a score by at most 4 d / range of that leg."""
    (sup_a, cae_a), (sup_b, cae_b) = legs_a, legs_b
    bound = 0.0
    for w, a, b in ((alpha, sup_a, sup_b), (1 - alpha, cae_a, cae_b)):
        bound += w * 4 * float(np.abs(a - b).max()) / float(a.max() - a.min())
    return bound


def submission_phase(dev, card: str) -> None:
    """Phase 16: the reference's submission path at full width (see the module docstring)."""
    import pandas as pd
    import torch

    from dfac_tpu_torch import chain_rates
    from dfac_tpu_torch.data.normalizer import build_normalizer
    from dfac_tpu_torch.ensemble.hybrid import fuse_scores
    from dfac_tpu_torch.models import build_model, fast_infer
    from dfac_tpu_torch.ops import _build
    from dfac_tpu_torch.profiling import profile_path
    from dfac_tpu_torch.train import rates
    from dfac_tpu_torch.train.cae_loop import cae_mse_scores
    from dfac_tpu_torch.train.checkpoint import save_checkpoint
    from dfac_tpu_torch.train.evaluate import predict_scores
    from dfac_tpu_torch.utils.convert import jax_from_state_dict

    features = TRAIN_FEATURES
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.manual_seed(SEED)
    models = {
        "cnn2d": build_model("cnn2d", in_features=features),
        "cnn1d": build_model("cnn1d", in_features=features),
        "cae": build_model("cae", base_channels=32),
    }
    models = {k: chain_rates.seed_batchnorm(m.to(dev).eval(), gen) for k, m in models.items()}
    sds = {k: m.state_dict() for k, m in models.items()}
    ds = rates.synthetic_dataset(CLI_UTTS, features, N_FRAMES, 20)
    norm = build_normalizer(ds.features, ds.labels)
    n_batches = -(-CLI_UTTS // BATCH)

    # -- the chains against the f32 eval models, and the hybrid's legs
    _build.reset_launch_counts()
    sup_fast = fast_infer.predict_scores_fast(sds["cnn2d"], ds, dev, BATCH)  # the hybrid --fast CNN2D leg: K2 bf16
    served = _build.launch_counts()
    require(served == {**dict.fromkeys(served, 0), "conv_block": 3 * n_batches},
            f"hybrid --fast CNN2D leg over {n_batches} batches: launches {served}")
    phase("submission", f"hybrid --fast CNN2D leg (predict_scores_fast, bf16): launches over {n_batches} batches "
                        f"{served}")
    _build.reset_launch_counts()
    legs = {"cnn2d": sup_fast}
    for dt in (torch.float32, torch.bfloat16):
        legs[f"cnn1d {str(dt)[6:]}"] = fast_infer.predict_scores_fast_cnn1d(sds["cnn1d"], ds, dev, BATCH,
                                                                           compute_dtype=dt)
        legs[f"cae {str(dt)[6:]}"] = fast_infer.cae_mse_scores_fast(sds["cae"], ds, norm, dev, BATCH, compute_dtype=dt)
    other = _build.launch_counts()
    require(not any(other.values()), f"the CNN1D and CAE chains launched kernels of the port: {other}")
    plain = {name: predict_scores(models[name], ds, BATCH, apply_sigmoid=True) for name in ("cnn2d", "cnn1d")}
    plain["cae"] = cae_mse_scores(models["cae"], ds, norm, BATCH)
    for name, got in legs.items():
        family, dt = (name.split() + ["bfloat16"])[:2]
        want = plain[family]
        require(got.shape == want.shape == (CLI_UTTS,) and np.isfinite(got).all(), f"{name}: {got.shape}")
        if family == "cae":
            err, tol = float((np.abs(got - want) / np.abs(want)).max()), CAE_RTOL[dt]
        else:
            err, tol = float(np.abs(got - want).max()), F32_SCORE_ATOL if dt == "float32" else SCORE_ATOL
        phase("submission", f"{name} fast chain vs the f32 eval model on {CLI_UTTS} utterances: max "
                            f"{'rel' if family == 'cae' else 'abs'} {err:.3e} (tolerance {tol}); range "
                            f"[{got.min():.6g}, {got.max():.6g}]")
        require(err <= tol, f"{name}: {err} > {tol}")
    hybrid_bound = {}
    for cnn in ("cnn2d", "cnn1d"):
        fast_legs = (legs[cnn if cnn == "cnn2d" else "cnn1d bfloat16"], legs["cae bfloat16"])
        plain_legs = (plain[cnn], plain["cae"])
        d = float(np.abs(fuse_scores(*fast_legs) - fuse_scores(*plain_legs)).max())
        bound = hybrid_bound[cnn] = fused_bound(0.80, plain_legs, fast_legs)
        agree = float(((fuse_scores(*fast_legs) > 0.5) == (fuse_scores(*plain_legs) > 0.5)).mean())
        phase("submission", f"predict-hybrid --fast vs without, --cnn-model {cnn}: max abs {d:.3e} (bound from "
                            f"the legs' tolerances above: {bound:.3e}), class agreement at 0.5 {agree:.4f}")
        require(d <= bound, f"hybrid {cnn}: {d} > {bound}")
    del plain, legs

    # -- the CLIs, as subprocesses on the split
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cli = [sys.executable, "-m"]
    with tempfile.TemporaryDirectory(prefix="dfac_smoke_submission_") as tmp:
        fpath, lpath = write_split(tmp, "dev", ds)
        ck = {k: os.path.join(tmp, f"{k}.ckpt") for k in sds}
        for k, sd in sds.items():
            save_checkpoint(ck[k], jax_from_state_dict(sd, k), config={"model": k})
        norm_path = os.path.join(tmp, "normalizer.npz")
        norm.save(norm_path)
        preds = {k: os.path.join(tmp, f"{k}.pkl") for k in ("predict", "hybrid", "hybrid-f32")}
        device = ["--device", dev.type, "--in-features", str(features)]
        hybrid = [*cli, "dfac_tpu_torch.cli.predict_hybrid", "--features", fpath, "--cnn-checkpoint", ck["cnn2d"],
                  "--cae-checkpoint", ck["cae"], "--normalizer", norm_path, *device]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        outs = run_all({
            "predict --model cnn1d --fast": [*cli, "dfac_tpu_torch.cli.predict", "--features", fpath, "--checkpoint",
                                             ck["cnn1d"], "--model", "cnn1d", "--fast", "--out", preds["predict"],
                                             *device],
            "train --model cnn1d": [*cli, "dfac_tpu_torch.cli.train", "--model", "cnn1d", "--train-features", fpath,
                                    "--train-labels", lpath, "--dev-features", fpath, "--dev-labels", lpath,
                                    "--epochs", "1", "--checkpoint-dir", os.path.join(tmp, "ck"), *device],
            "evaluate-cae": [*cli, "dfac_tpu_torch.cli.evaluate_cae", "--features", fpath, "--labels", lpath,
                             "--checkpoint", ck["cae"], "--normalizer", norm_path, "--device", dev.type],
            "hybrid-ensemble": [*cli, "dfac_tpu_torch.cli.hybrid_ensemble", "--features", fpath, "--labels", lpath,
                                "--cnn-checkpoint", ck["cnn2d"], "--cae-checkpoint", ck["cae"], "--normalizer",
                                norm_path, *device],
            "ensemble": [*cli, "dfac_tpu_torch.cli.ensemble", "--features", fpath, "--labels", lpath, "--checkpoints",
                         f"cnn2d:{ck['cnn2d']}", f"cnn1d:{ck['cnn1d']}", *device],
            "predict-hybrid --fast": hybrid + ["--fast", "--out", preds["hybrid"]],
            "predict-hybrid": hybrid + ["--out", preds["hybrid-f32"]],
        }, env)
        outs["generate-submission"] = subprocess.run(
            [*cli, "dfac_tpu_torch.cli.generate_submission", fpath, preds["hybrid"], "S0", "Smoke", "Test", "card"],
            check=True, capture_output=True, text=True, cwd=tmp, env=env).stdout
        phase("submission", f"8 CLIs (7 concurrent, then generate-submission): {time.perf_counter() - t0:.1f}s")
        for label, out in outs.items():
            require(out.strip(), f"{label} printed nothing")
            for line in out.strip().splitlines():
                phase("submission", f"cli {label}: {line}")
        require(os.path.exists(os.path.join(tmp, "ck", "cnn1d_best.ckpt")), "train --model cnn1d: no checkpoint")
        require(len(re.findall(r"^  alpha=", outs["hybrid-ensemble"], re.M)) == 21, "hybrid-ensemble: no sweep")
        sub = pd.read_pickle(os.path.join(tmp, "S0-Smoke-Test-card.pkl"))
        cli_fused = {k: pd.read_pickle(preds[k])["predictions"].to_numpy() for k in ("hybrid", "hybrid-f32")}
        require(np.array_equal(sub["predictions"]["predictions"].to_numpy(), cli_fused["hybrid"]),
                "the submission's predictions are not predict-hybrid --fast's")
        d = float(np.abs(cli_fused["hybrid"] - cli_fused["hybrid-f32"]).max())
        phase("submission", f"CLI predict-hybrid --fast vs without: max abs {d:.3e} (bound {hybrid_bound['cnn2d']:.3e},"
                            f" from the legs in process); the submission file holds the --fast predictions")
        require(d <= hybrid_bound["cnn2d"], f"CLI hybrid: {d} > {hybrid_bound['cnn2d']}")

    # -- rates over on-device feature tensors, and one profile of each chain
    feats = torch.randn(F32_CORPUS // BATCH, BATCH, features, N_FRAMES, device=dev, generator=gen)  # stored (F, T)
    mean = torch.as_tensor(norm.mean, device=dev)
    std = torch.as_tensor(norm.std, device=dev)
    chains = {}
    for dt in (torch.float32, torch.bfloat16):
        f1 = fast_infer.on_device(fast_infer.fold_cnn1d(sds["cnn1d"]), dev, dt)
        fc = fast_infer.on_device(fast_infer.fold_cae(sds["cae"]), dev, dt)
        name = str(dt)[6:]
        chains[f"cnn1d {name}"] = lambda f, f1=f1, dt=dt: fast_infer.cnn1d_fast_scores(f1, f, compute_dtype=dt)
        chains[f"cae {name}"] = lambda f, fc=fc, dt=dt: fast_infer.cae_fast_mse(fc, f, mean, std, compute_dtype=dt)
    f2 = {k: v.to(dev) for k, v in fast_infer.fold_cnn2d(sds["cnn2d"]).items()}
    chains["hybrid legs bf16"] = lambda f: (fast_infer.cnn2d_fast_scores(f2, f), chains["cae bfloat16"](f))
    _build.reset_launch_counts()
    for name, score in chains.items():
        r = chain_rates.rates(chain_rates.runner(score, feats), F32_CORPUS)
        phase("submission", chain_rates.summary(name, r) + f", {F32_CORPUS} feature tensors ({features} x {N_FRAMES})"
                                                           f" at B={BATCH}, on {card}")
    timed = _build.launch_counts()
    n_runs = (chain_rates.REPS + 1) * (F32_CORPUS // BATCH)
    require(timed == {**dict.fromkeys(timed, 0), "conv_block": 3 * n_runs}, f"timed runs' launches: {timed}")
    for name in ("cae bfloat16", "cae float32", "cnn1d float32", "cnn1d bfloat16"):
        profile_path(f"{name} B={BATCH}", chain_rates.runner(chains[name], feats), F32_CORPUS // BATCH, dev)
    del feats


def alt_dataset(n: int, seed: int):
    """``rates.synthetic_dataset`` at full width with 160..321 valid frames
    an utterance (pad frames zero), as the detector's variable-length
    corpora come."""
    from dfac_tpu_torch.train import rates

    ds = rates.synthetic_dataset(n, TRAIN_FEATURES, N_FRAMES, seed)
    ds.lengths = np.random.default_rng(seed).integers(ALT_MIN_FRAMES, N_FRAMES + 1, size=n).astype(np.int32)
    ds.features *= np.arange(N_FRAMES)[None, None, :] < ds.lengths[:, None, None]
    return ds


def alt_trainers_phase(dev, card: str) -> None:
    """Phase 17: the CAE trainer and the detector at full width (see the module docstring)."""
    import pandas as pd
    import torch

    from dfac_tpu_torch.data.normalizer import FeatureNormalizer, build_normalizer
    from dfac_tpu_torch.data.pipeline import load_dataset
    from dfac_tpu_torch.ensemble.hybrid import fuse_scores
    from dfac_tpu_torch.models import build_model, fast_infer
    from dfac_tpu_torch.ops import _build
    from dfac_tpu_torch.train import rates
    from dfac_tpu_torch.train.cae_loop import CAEConfig, CAETrainer, evaluate_cae
    from dfac_tpu_torch.train.checkpoint import load_model_variables, save_checkpoint
    from dfac_tpu_torch.train.detector_loop import DetectorConfig, DetectorTrainer, compute_class_weights
    from dfac_tpu_torch.utils.convert import jax_from_state_dict
    from dfac_tpu_torch import chain_rates

    features = TRAIN_FEATURES
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cli = [sys.executable, "-m"]
    with tempfile.TemporaryDirectory(prefix="dfac_smoke_alt_") as tmp:
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ck")
        paths = {name: write_split(data, name, alt_dataset(n, 30 + i)) for i, (name, n) in enumerate(ALT_UTTS.items())}
        # -- the two training CLIs, host-fed and device-resident, at the recipe's batch
        cae = [*cli, "dfac_tpu_torch.cli.train_cae", "--train-features", paths["train"][0], "--train-labels",
               paths["train"][1], "--dev-features", paths["dev"][0], "--dev-labels", paths["dev"][1], "--epochs",
               "2", "--batch-size", str(TRAIN_BATCH), "--base-channels", str(CAE_BASE), "--no-rich",
               "--device", dev.type]
        # EMA decay 0.9, not the recipe's 0.999: over 32 steps the checkpointed EMA weights then move
        # away from the init, so the scoring checks below see a trained model's logits
        det = [*cli, "dfac_tpu_torch.cli.train_detector", "--data-dir", data, "--epochs", "2", "--batch-size",
               str(TRAIN_BATCH), "--hidden", str(DETECTOR_HIDDEN), "--ema", "--ema-decay", "0.9", "--specaug",
               "--device", dev.type]
        t0 = time.perf_counter()
        outs = run_all({
            "train_cae": cae + ["--checkpoint-dir", os.path.join(ck, "cae_host")],
            "train_cae --device-resident": cae + ["--checkpoint-dir", os.path.join(ck, "cae_resident"),
                                                  "--device-resident"],
            "train_detector": det + ["--ckpt-path", os.path.join(ck, "det_host.ckpt"), "--prediction-pkl",
                                     os.path.join(tmp, "det_host.pkl")],
            "train_detector --device-resident": det + ["--ckpt-path", os.path.join(ck, "det_resident.ckpt"),
                                                       "--prediction-pkl", os.path.join(tmp, "det_resident.pkl"),
                                                       "--device-resident"],
        }, env)
        phase("alt-trainers", f"train_cae x2 and train_detector x2 (concurrent, 2 epochs at B={TRAIN_BATCH}, "
                              f"{ALT_UTTS['train']} train utterances): {time.perf_counter() - t0:.1f}s")
        best_mse, det_eer = {}, {}
        for label, out in outs.items():
            for line in out.strip().splitlines():
                phase("alt-trainers", f"cli {label}: {line}")
            if label.startswith("train_cae"):
                run_dir = os.path.join(ck, "cae_resident" if "resident" in label else "cae_host")
                for name in ("cae_best.ckpt", "cae_last.ckpt", "normalizer.npz"):
                    require(os.path.exists(os.path.join(run_dir, name)), f"{label}: no {name}")
                require(len(re.findall(r"^  epoch +\d+ ", out, re.M)) == 2, f"{label}: not 2 epoch lines")
                best_mse[label] = float(re.search(r"^best val reconstruction MSE: (\S+)$", out, re.M).group(1))
                require(np.isfinite(best_mse[label]) and best_mse[label] > 0, f"{label}: {best_mse[label]}")
            else:
                require(re.search(r"^Training done\. Best dev EER: ", out, re.M), f"{label}: no training line")
                det_eer[label] = float(re.search(r"^EER on split 'test2': (\S+)$", out, re.M).group(1))
                pred = pd.read_pickle(os.path.join(tmp, "det_resident.pkl" if "resident" in label else
                                                   "det_host.pkl"))
                require(len(pred) == ALT_UTTS["test2"] and np.isfinite(pred["predictions"]).all(), f"{label}: pred")
        a, b = best_mse.values()
        require(abs(a - b) <= 1e-3 * abs(a), f"train_cae host-fed {a} and resident {b} disagree")
        phase("alt-trainers", f"train_cae best val MSE host-fed {a!r}, resident {b!r}; train_detector test2 EER "
                              f"host-fed {det_eer['train_detector']!r}, resident "
                              f"{det_eer['train_detector --device-resident']!r}")

        # -- serve the trained CAE (evaluate_cae, predict_hybrid --fast) and score the trained detector
        cae_dir = os.path.join(ck, "cae_host")
        cae_ckpt, norm_path = os.path.join(cae_dir, "cae_best.ckpt"), os.path.join(cae_dir, "normalizer.npz")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.manual_seed(SEED)
        cnn = chain_rates.seed_batchnorm(build_model("cnn2d", in_features=features).to(dev).eval(), gen)
        cnn_ckpt = os.path.join(tmp, "cnn2d.ckpt")
        save_checkpoint(cnn_ckpt, jax_from_state_dict(cnn.state_dict(), "cnn2d"), config={"model": "cnn2d"})
        det_ckpt = os.path.join(ck, "det_host.ckpt")
        score = [*cli, "dfac_tpu_torch.cli.train_detector", "--data-dir", data, "--epochs", "0", "--hidden",
                 str(DETECTOR_HIDDEN), "--batch-size", str(BATCH), "--ckpt-path", det_ckpt, "--device", dev.type]
        preds = {k: os.path.join(tmp, f"{k}.pkl") for k in ("plain", "fast", "bf16", "hybrid")}
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        outs = run_all({
            "evaluate_cae": [*cli, "dfac_tpu_torch.cli.evaluate_cae", "--features", paths["dev"][0], "--labels",
                             paths["dev"][1], "--checkpoint", cae_ckpt, "--normalizer", norm_path,
                             "--base-channels", str(CAE_BASE), "--device", dev.type],
            "predict_hybrid --fast": [*cli, "dfac_tpu_torch.cli.predict_hybrid", "--features", paths["dev"][0],
                                      "--cnn-checkpoint", cnn_ckpt, "--cae-checkpoint", cae_ckpt, "--normalizer",
                                      norm_path, "--base-channels", str(CAE_BASE), "--fast", "--out",
                                      preds["hybrid"], "--device", dev.type],
            "train_detector --epochs 0": score + ["--prediction-pkl", preds["plain"]],
            "train_detector --epochs 0 --fast": score + ["--prediction-pkl", preds["fast"], "--fast"],
            "train_detector --epochs 0 --fast --bf16": score + ["--prediction-pkl", preds["bf16"], "--fast",
                                                                "--bf16"],
        }, env)
        phase("alt-trainers", f"evaluate_cae, predict_hybrid --fast and train_detector --epochs 0 x3 (concurrent): "
                              f"{time.perf_counter() - t0:.1f}s")
        for label, out in outs.items():
            for line in out.strip().splitlines():
                phase("alt-trainers", f"cli {label}: {line}")
        # the trained CAE in process: its EER, and the hybrid's legs (K2 on the CNN2D leg)
        dev_ds = load_dataset(*paths["dev"])
        norm = FeatureNormalizer.load(norm_path)
        cae_sd = load_model_variables(cae_ckpt, model_name="cae")
        cae_model = build_model("cae", base_channels=CAE_BASE)
        cae_model.load_state_dict(cae_sd)
        rep = evaluate_cae(cae_model.to(dev), dev_ds, norm, BATCH)
        cli_eer = float(re.search(r"^best convention: \S+  EER: (\S+)", outs["evaluate_cae"], re.M).group(1))
        require(abs(cli_eer - rep["eer"]) <= 5e-7, f"evaluate_cae CLI eer {cli_eer}, in process {rep['eer']}")
        n_batches = -(-ALT_UTTS["dev"] // BATCH)
        _build.reset_launch_counts()
        sup = fast_infer.predict_scores_fast(cnn.state_dict(), dev_ds, dev, BATCH)
        served = _build.launch_counts()
        require(served == {**dict.fromkeys(served, 0), "conv_block": 3 * n_batches},
                f"hybrid --fast CNN2D leg over {n_batches} batches: launches {served}")
        cae_fast = fast_infer.cae_mse_scores_fast(cae_sd, dev_ds, norm, dev, BATCH)
        err = float((np.abs(cae_fast - rep["scores"]) / np.abs(rep["scores"])).max())
        require(err <= CAE_RTOL["bfloat16"], f"trained CAE bf16 chain vs its f32 eval model: {err}")
        d_hybrid = float(np.abs(fuse_scores(sup, cae_fast) - pd.read_pickle(preds["hybrid"])["predictions"]).max())
        require(d_hybrid <= 1e-5, f"predict_hybrid --fast CLI vs in process: {d_hybrid}")
        phase("alt-trainers", f"trained CAE: evaluate_cae EER {rep['eer']!r} ({rep['convention']}) in process and "
                              f"by the CLI; bf16 chain vs f32 eval model max rel {err:.3e} (tolerance "
                              f"{CAE_RTOL['bfloat16']}); hybrid --fast CNN2D leg launches over {n_batches} batches "
                              f"{served}; predict_hybrid --fast CLI vs in process max abs {d_hybrid:.3e}")
        det_scores = {k: pd.read_pickle(preds[k])["predictions"].to_numpy() for k in ("plain", "fast", "bf16")}
        d32 = float(np.abs(det_scores["fast"] - det_scores["plain"]).max())
        d16 = float(np.abs(det_scores["bf16"] - det_scores["plain"]).max())
        phase("alt-trainers", f"trained detector on test2 ({ALT_UTTS['test2']} utterances, logits in "
                              f"[{det_scores['plain'].min():.4f}, {det_scores['plain'].max():.4f}]): --fast f32 vs "
                              f"plain max abs {d32:.3e} (tolerance {F32_SCORE_ATOL}), --fast --bf16 {d16:.3e} "
                              f"(tolerance {DETECTOR_BF16_ATOL})")
        require(d32 <= F32_SCORE_ATOL and d16 <= DETECTOR_BF16_ATOL, "the detector's folded chain disagrees")
        del cnn, cae_model

    # -- ms per step and utt/s, host-fed and device-resident; one profiled epoch each at B=512
    _build.reset_launch_counts()
    for b, steps in TRAIN_STEPS.items():
        for name in ("cae", "detector"):
            # the CAE's, a bonafide corpus; the detector's, of 160..321 valid frames
            ds = rates.synthetic_dataset(b * steps, features, N_FRAMES, 40) if name == "cae" else alt_dataset(
                b * steps, 41)
            for resident in (False, True):
                if name == "cae":
                    trainer = CAETrainer(CAEConfig(batch_size=b, base_channels=CAE_BASE, device_resident=resident),
                                         device=dev)
                    trainer.init_state()
                    trainer.use_normalizer(build_normalizer(ds.features, None))

                    def run(i, trainer=trainer, ds=ds):
                        return trainer.train_epoch(ds, 100 + i)

                    conv_in = (b, 1, N_FRAMES, features)
                else:
                    trainer = DetectorTrainer(DetectorConfig(batch_size=b, hidden=DETECTOR_HIDDEN, ema=True,
                                                             specaug=True, device_resident=resident),
                                              in_channels=features, device=dev)
                    trainer.init_state()
                    pos_weight = compute_class_weights(ds.labels)[0]
                    orders = np.random.default_rng(SEED)

                    def run(i, trainer=trainer, ds=ds, pos_weight=pos_weight, orders=orders):
                        return float(trainer.train_epoch(ds, orders.choice(len(ds), len(ds)), pos_weight)[0])

                    conv_in = (b, features, N_FRAMES)
                secs = rates.run_seconds(run)
                ms = [1e3 * t / steps for t in secs]
                utt = [len(ds) / t for t in secs]
                phase("alt-trainers", f"{name} train step B={b} {'device-resident' if resident else 'host-fed'}: "
                                      f"{statistics.median(ms):.4f} ms (median of {len(ms)} epochs of {steps} steps; "
                                      f"min {min(ms):.4f}, max {max(ms):.4f}), {statistics.median(utt):.1f} utt/s "
                                      f"(min {min(utt):.1f}, max {max(utt):.1f}), f32 convs, on {card}")
                if b == TRAIN_BIG_BATCH and resident:
                    prof = rates.profile_run(lambda: run(200), dev, steps, conv_in)
                    share = (lambda t: t / prof["device_ms"]) if prof["device_ms"] else (lambda t: float("nan"))
                    phase("alt-trainers", f"profile {name} B={b} device-resident: device {prof['device_ms']:.4f} ms a "
                                          f"step, busy {prof['device_ms'] / statistics.median(ms):.1%} of the "
                                          f"{statistics.median(ms):.4f} ms step (profiled wall {prof['wall_ms']:.4f} "
                                          f"ms), on {card}")
                    for k_name, k_ms, n in prof["top"]:
                        phase("alt-trainers", f"  {k_ms:8.4f} ms {share(k_ms):6.1%} {n:5.1f}x  {k_name[:110]}")
                del trainer
                torch.cuda.empty_cache()
            del ds
    trained = _build.launch_counts()
    require(not any(trained.values()), f"the alternative trainers launched kernels of the port: {trained}")
    phase("alt-trainers", f"launches over the timed training runs: {trained} (cuDNN and cuBLAS only)")


def largest_batch(make_trainer, ds_for, start: int) -> tuple[int, list[str]]:
    """The largest power of two up to ``start`` at which one train step of
    ``make_trainer(b)`` fits in the card's memory, and the batches that did
    not fit (an ``OutOfMemoryError`` at one of them is the finding, not a
    failure)."""
    import torch

    b, refused = start, []
    while True:
        trainer = make_trainer(b)
        try:
            trainer.train_epoch(ds_for(b, 1), 0)
            return b, refused
        except torch.cuda.OutOfMemoryError:
            refused.append(str(b))
            b //= 2
            require(b >= TRAIN_BATCH, f"not even B={2 * b} fits")
        finally:
            del trainer
            torch.cuda.empty_cache()


def zoo_phase(dev, card: str) -> None:
    """Phase 18: the zoo, CNN1DVariant, bf16 training and the sweep CLIs at full width (see the module docstring)."""
    import pandas as pd
    import torch

    from dfac_tpu_torch.data.pipeline import load_dataset
    from dfac_tpu_torch.models import model_from_state_dict
    from dfac_tpu_torch.ops import _build
    from dfac_tpu_torch.ops.eer import calculate_eer
    from dfac_tpu_torch.train import rates
    from dfac_tpu_torch.train import loop as train_loop
    from dfac_tpu_torch.train.checkpoint import load_checkpoint, load_model_variables
    from dfac_tpu_torch.train.detector_loop import DetectorConfig, DetectorTrainer, compute_class_weights
    from dfac_tpu_torch.train.evaluate import evaluate_classifier

    features = TRAIN_FEATURES
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cli = [sys.executable, "-m"]
    _build.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="dfac_smoke_zoo_") as tmp:
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ck")
        paths = {name: write_split(data, name, alt_dataset(n, 50 + i) if name == "test2" else
                                   rates.synthetic_dataset(n, features, N_FRAMES, 50 + i))
                 for i, (name, n) in enumerate(ZOO_UTTS.items())}
        split = ["--train-features", paths["train"][0], "--train-labels", paths["train"][1], "--dev-features",
                 paths["dev"][0], "--dev-labels", paths["dev"][1], "--batch-size", str(TRAIN_BATCH), "--seed",
                 str(SEED), "--in-features", str(features), "--device", dev.type]
        train = [*cli, "dfac_tpu_torch.cli.train", *split, "--epochs", "2", "--no-rich"]
        commands = {f"train --model {m}": train + ["--model", m, "--checkpoint-dir", os.path.join(ck, m)] for m in ZOO}
        for m in ("cnn2d", "cnn1d"):
            commands[f"train --model {m} --bf16"] = train + ["--model", m, "--bf16", "--checkpoint-dir",
                                                             os.path.join(ck, f"{m}_bf16")]
        commands["train_detector --bf16"] = [
            *cli, "dfac_tpu_torch.cli.train_detector", "--data-dir", data, "--epochs", "2", "--batch-size",
            str(TRAIN_BATCH), "--hidden", str(DETECTOR_HIDDEN), "--bf16", "--ckpt-path", os.path.join(ck, "det.ckpt"),
            "--prediction-pkl", os.path.join(tmp, "det.pkl"), "--device", dev.type]
        commands["compare_kernels --epochs 1"] = [*cli, "dfac_tpu_torch.cli.compare_kernels", *split, "--epochs", "1",
                                                  "--checkpoint-dir", os.path.join(ck, "kernels")]
        commands["compare_normalization --epochs 1"] = [*cli, "dfac_tpu_torch.cli.compare_normalization", *split,
                                                        "--epochs", "1"]
        bench = os.path.join(tmp, "bench")
        commands["benchmark"] = [*cli, "dfac_tpu_torch.cli.benchmark", *split, "--models", "cnn2d,crnn+specaug",
                                 "--seeds", "0,1", "--epochs", "1", "--output-dir", bench]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        outs = run_all(commands, env)
        phase("zoo", f"{len(commands)} CLIs (concurrent: train x{len(ZOO) + 2}, train_detector --bf16, "
                     f"compare_kernels, compare_normalization, benchmark; {ZOO_UTTS['train']} / {ZOO_UTTS['dev']} "
                     f"utterances, B={TRAIN_BATCH}): {time.perf_counter() - t0:.1f}s")
        for label, out in outs.items():
            for line in out.strip().splitlines():
                phase("zoo", f"cli {label}: {line}")
        ckpts = {}
        for m in (*ZOO, "cnn2d_bf16", "cnn1d_bf16"):
            label = f"train --model {m.replace('_bf16', ' --bf16')}"
            losses = epoch_losses(outs[label])
            require(len(losses) == 2 and all(np.isfinite(losses)), f"{label}: epoch losses {losses}")
            ckpts[m] = os.path.join(ck, m, f"{m.replace('_bf16', '')}_best.ckpt")
            for kind in ("best", "last"):
                require(os.path.exists(ckpts[m].replace("_best", f"_{kind}")), f"{label}: no {kind} checkpoint")
        out = outs["train_detector --bf16"]
        require(re.search(r"^Training done\. Best dev EER: ", out, re.M) and
                re.search(r"^EER on split 'test2': ", out, re.M), "train_detector --bf16: lines")
        require(np.isfinite(pd.read_pickle(os.path.join(tmp, "det.pkl"))["predictions"]).all(), "detector bf16: pred")
        kernel_rows = re.findall(r"^\[(k\d-\d-\d_\w+)\] best dev EER = (\S+)$", outs["compare_kernels --epochs 1"], re.M)
        require(len(kernel_rows) == 4, f"compare_kernels: rows {kernel_rows}")
        for label, _ in kernel_rows:
            cfg = load_checkpoint(os.path.join(ck, "kernels", f"{label}.ckpt"))["config"]
            require(cfg["model"] == "cnn1d_variant" and label == f"k{'-'.join(map(str, cfg['kernel_sizes']))}_"
                    f"{cfg['normalization']}", f"compare_kernels: {label}'s metadata {cfg}")
        norm_rows = re.findall(r"^(raw|cmn|cvmn) +(\S+)$", outs["compare_normalization --epochs 1"], re.M)
        require([r[0] for r in norm_rows] == ["raw", "cmn", "cvmn"], f"compare_normalization: table {norm_rows}")
        runs = pd.read_csv(os.path.join(bench, "model_runs.csv"))
        require(runs[["model", "seed"]].values.tolist() == [["cnn2d", 0], ["cnn2d", 1], ["crnn+specaug", 0],
                                                            ["crnn+specaug", 1]], f"benchmark runs {runs}")
        for name in ("model_epochs.csv", "model_ranking.csv", "benchmark_report.md"):
            require(os.path.exists(os.path.join(bench, name)), f"benchmark: no {name}")
        plots = sorted(os.path.relpath(os.path.join(d, f), bench) for d, _, fs in os.walk(bench) for f in fs
                       if f.endswith(".png"))
        phase("zoo", f"benchmark: model_runs.csv {len(runs)} rows, best dev EERs {runs['best_dev_eer'].tolist()}; "
                     f"model_epochs.csv, model_ranking.csv, benchmark_report.md; plots: {plots or 'none (matplotlib'
                     ' is not installed here: the harness skips them, as the JAX one does)'}")

        # -- the checkpoints through ensemble, against evaluate_classifier in process; predict --bf16 plain vs --fast
        ckpts["cnn1d_variant"] = os.path.join(ck, "kernels", "k5-3-3_raw.ckpt")
        specs = {m: f"{'cnn2d' if m == 'cnn2d_bf16' else 'cnn1d' if m == 'cnn1d_bf16' else m}:{c}"
                 for m, c in ckpts.items()}
        preds = {k: os.path.join(tmp, f"{k}.pkl") for k in ("ensemble", "plain", "fast")}
        predict = [*cli, "dfac_tpu_torch.cli.predict", "--features", paths["dev"][0], "--checkpoint",
                   ckpts["cnn2d_bf16"], "--model", "cnn2d", "--bf16", "--batch-size", str(BATCH), "--device", dev.type]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        outs = run_all({
            "ensemble": [*cli, "dfac_tpu_torch.cli.ensemble", "--features", paths["dev"][0], "--labels",
                         paths["dev"][1], "--checkpoints", *specs.values(), "--out", preds["ensemble"],
                         "--device", dev.type],
            "predict --bf16": predict + ["--out", preds["plain"]],
            "predict --fast --bf16": predict + ["--out", preds["fast"], "--fast"],
        }, env)
        phase("zoo", f"ensemble of {len(specs)} checkpoints and predict --bf16 with and without --fast (concurrent): "
                     f"{time.perf_counter() - t0:.1f}s")
        for label, out in outs.items():
            for line in out.strip().splitlines():
                phase("zoo", f"cli {label}: {line}")
        dev_ds = load_dataset(*paths["dev"])
        in_process = []
        for m, spec in specs.items():
            arch = spec.split(":")[0]
            model = model_from_state_dict(arch, load_model_variables(ckpts[m], model_name=arch)).to(dev)
            _, scores, _ = evaluate_classifier(model, dev_ds, batch_size=BATCH, apply_sigmoid=True)
            eer = calculate_eer(scores, dev_ds.labels)[0]
            require(f"{spec}: EER={eer:.6f} " in outs["ensemble"], f"ensemble: {spec}'s EER, in process {eer}")
            in_process.append(scores)
            del model
        d_ens = float(np.abs(np.mean(in_process, axis=0) - pd.read_pickle(preds["ensemble"])["predictions"]).max())
        p16 = {k: pd.read_pickle(preds[k])["predictions"].to_numpy() for k in ("plain", "fast")}
        d16 = float(np.abs(p16["plain"] - p16["fast"]).max())
        phase("zoo", f"ensemble of the {len(specs)} trained checkpoints (8 zoo, CNN1DVariant k5-3-3, CNN2D and CNN1D "
                     f"bf16): each EER as in process, the mean vs evaluate_classifier's in process max abs "
                     f"{d_ens:.3e} (tolerance {ENSEMBLE_ATOL}); predict --bf16 vs predict --fast --bf16 on the "
                     f"bf16-trained CNN2D max abs {d16:.3e} (tolerance {SCORE_ATOL})")
        require(d_ens <= ENSEMBLE_ATOL and d16 <= SCORE_ATOL, "the ensemble or the bf16 chains disagree")

    # -- ms per step and utt/s, f32, device-resident: each zoo model at B=32 and B=512 (or the largest that fits)
    def zoo_trainer(name, b, dtype=None):
        cfg = train_loop.TrainConfig(model=name, batch_size=b, in_features=features, seed=SEED, device_resident=True,
                                     compute_dtype=dtype)
        trainer = train_loop.Trainer(cfg, device=dev)
        trainer.init_state()
        return trainer

    def steps_ds(b, steps):
        return rates.synthetic_dataset(b * steps, features, N_FRAMES, 60)

    def timed(label, trainer, ds, steps, run=None):
        """Median ms a step over ``rates.run_seconds``' epochs; every epoch's loss must be finite."""
        losses = []

        def epoch(i):
            losses.append(float(run(i) if run else trainer.train_epoch(ds, 1 + i)))

        ms = [1e3 * t / steps for t in rates.run_seconds(epoch)]
        utt = [trainer.cfg.batch_size * 1e3 / t for t in ms]
        require(all(np.isfinite(losses)), f"{label}: epoch losses {losses}")
        phase("zoo", f"{label}: {statistics.median(ms):.4f} ms a step (median of {len(ms)} epochs of {steps} steps; "
                     f"min {min(ms):.4f}, max {max(ms):.4f}), {statistics.median(utt):.1f} utt/s, epoch losses "
                     f"finite, on {card}")
        return statistics.median(ms)

    slowest = (0.0, None, None, None)
    for name in ZOO:
        for b, steps in ZOO_STEPS.items():
            if b == TRAIN_BIG_BATCH:
                b, refused = largest_batch(lambda bb: zoo_trainer(name, bb), lambda bb, n: steps_ds(bb, n), b)
                if refused:
                    phase("zoo", f"{name}: B={', '.join(refused)} does not fit in the card's memory "
                                 f"(OutOfMemoryError); timed at B={b}, the largest power of two that fits")
            trainer = zoo_trainer(name, b)
            ms = timed(f"{name} train step B={b} f32 device-resident", trainer, steps_ds(b, steps), steps)
            if steps == ZOO_STEPS[TRAIN_BIG_BATCH] and ms * TRAIN_BIG_BATCH / b > slowest[0]:
                slowest = (ms * TRAIN_BIG_BATCH / b, name, b, ms)
            del trainer
            torch.cuda.empty_cache()

    # -- bf16 against f32 at B=512: CNN2D, CNN1D, the detector; every epoch's loss finite
    b, steps = TRAIN_BIG_BATCH, ZOO_STEPS[TRAIN_BIG_BATCH]
    ds = steps_ds(b, steps)
    for name in ("cnn2d", "cnn1d"):
        for dtype in (None, "bfloat16"):
            trainer = zoo_trainer(name, b, dtype)
            ms = timed(f"{name} train step B={b} {dtype or 'float32'} device-resident", trainer, ds, steps)
            if name == "cnn2d" and dtype:
                zoo_profile("cnn2d bf16", b, ms, rates.profile_epoch(trainer, ds, 400, (b, 1, N_FRAMES, features)),
                            card)
            del trainer
            torch.cuda.empty_cache()
    det_ds = alt_dataset(b * steps, 61)
    pos_weight = compute_class_weights(det_ds.labels)[0]
    for dtype in (None, "bfloat16"):
        trainer = DetectorTrainer(DetectorConfig(batch_size=b, hidden=DETECTOR_HIDDEN, ema=True, specaug=True,
                                                 device_resident=True, compute_dtype=dtype),
                                  in_channels=features, device=dev)
        trainer.init_state()
        orders = np.random.default_rng(SEED)
        timed(f"detector train step B={b} {dtype or 'float32'} device-resident", trainer, det_ds, steps,
              run=lambda i, trainer=trainer, orders=orders: trainer.train_epoch(
                  det_ds, orders.choice(len(det_ds), len(det_ds)), pos_weight)[0])
        del trainer
        torch.cuda.empty_cache()

    # -- one profile of the slowest zoo step
    _, name, b, ms = slowest
    trainer = zoo_trainer(name, b)
    ds = steps_ds(b, ZOO_STEPS[TRAIN_BIG_BATCH])
    trainer.train_epoch(ds, 0)
    zoo_profile(name, b, ms, rates.profile_epoch(trainer, ds, 500, (b, 1, N_FRAMES, features)), card)
    del trainer
    trained = _build.launch_counts()
    require(not any(trained.values()), f"the zoo and bf16 training launched kernels of the port: {trained}")
    phase("zoo", f"launches over the timed training runs: {trained} (cuDNN and cuBLAS only)")


def zoo_profile(label: str, b: int, step_ms: float, prof: dict, card: str) -> None:
    """Phase 18's lines for one profiled epoch: device ms a step, the busy
    share of the unprofiled step, the largest device items."""
    share = (lambda t: t / prof["device_ms"]) if prof["device_ms"] else (lambda t: float("nan"))
    phase("zoo", f"profile {label} B={b} device-resident: device {prof['device_ms']:.4f} ms a step, busy "
                 f"{prof['device_ms'] / step_ms:.1%} of the {step_ms:.4f} ms step (profiled wall {prof['wall_ms']:.4f} "
                 f"ms), on {card}")
    for k_name, k_ms, n in prof["top"]:
        phase("zoo", f"  {k_ms:8.4f} ms {share(k_ms):6.1%} {n:5.1f}x  {k_name[:110]}")


def w8a8_mode(args) -> str:
    """The output mode of ``conv_block_w8a8(x, w, deq, b, inv_s, time_mean)`` called with ``args``."""
    return "int8 pooled" if args[4] is not None else "mean" if args[5] else "f32"


def rows(ds, a: int, b: int):
    """Rows ``a:b`` of an ArrayDataset (views of its arrays)."""
    return type(ds)(uttids=ds.uttids[a:b], features=ds.features[a:b],
                    labels=None if ds.labels is None else ds.labels[a:b])


def int8_tools_phase(dev, card: str) -> dict:
    """Phase 19: w8a8 serving, int8 ingest, the host quantizer, anomaly embeddings, the data tools and
    ``--profile-dir`` (see the module docstring); returns ``conv_block_w8a8``'s and ``block1_w8a8``'s entries of
    the kernels line."""
    import copy

    import pandas as pd
    import torch

    from dfac_tpu_torch import chain_rates
    from dfac_tpu_torch.ensemble import anomaly
    from dfac_tpu_torch.io import fastcast
    from dfac_tpu_torch.io.npy_store import load_npy_dataset, save_npy_dataset
    from dfac_tpu_torch.io.pickle_io import write_predictions
    from dfac_tpu_torch.io.prefetch import PrefetchStats
    from dfac_tpu_torch.io.submission import generate_submission
    from dfac_tpu_torch.models import build_model, fast_infer
    from dfac_tpu_torch.models import fast_infer_int8 as w8
    from dfac_tpu_torch.ops import _build
    from dfac_tpu_torch.ops.conv_block_w8a8 import block1_w8a8, conv_block_w8a8, reference_block1_w8a8, \
        reference_conv_block_w8a8
    from dfac_tpu_torch.profiling import profile_path
    from dfac_tpu_torch.train import rates
    from dfac_tpu_torch.train.checkpoint import save_checkpoint
    from dfac_tpu_torch.utils.convert import jax_from_state_dict

    features = TRAIN_FEATURES
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.manual_seed(SEED)
    models = {k: chain_rates.seed_batchnorm(build_model(k, in_features=features).to(dev).eval(), gen)
              for k in ("cnn2d", "cnn1d")}
    sds = {k: m.state_dict() for k, m in models.items()}
    ds = rates.synthetic_dataset(CLI_UTTS, features, N_FRAMES, 20)
    n_batches = -(-CLI_UTTS // BATCH)

    # -- the w8a8 chain and int8 ingest in process: launches, and scores against the f32 --fast chain
    f32_ref = {"cnn2d": fast_infer.predict_scores_fast(sds["cnn2d"], ds, dev, BATCH, compute_dtype=torch.float32),
               "cnn1d": fast_infer.predict_scores_fast_cnn1d(sds["cnn1d"], ds, dev, BATCH,
                                                             compute_dtype=torch.float32)}
    served = {}
    for name, run in (
        ("w8a8 f32", lambda: w8.predict_scores_w8a8(sds["cnn2d"], ds, dev, BATCH, compute_dtype=torch.float32)),
        ("ingest-int8 cnn2d f32", lambda: fast_infer.predict_scores_fast(sds["cnn2d"], ds, dev, BATCH,
                                                                          compute_dtype=torch.float32,
                                                                          ingest_int8=True)),
    ):
        _build.reset_launch_counts()
        got = run()
        served[name] = _build.launch_counts()
        per = W8A8_PER_BATCH if name.startswith("w8a8") else {"conv_block": 3}
        want = {**dict.fromkeys(served[name], 0), **{k: n * n_batches for k, n in per.items()}}
        require(served[name] == want, f"{name} over {n_batches} batches: launches {served[name]}")
        d = float(np.abs(got - f32_ref["cnn2d"]).max())
        phase("int8", f"{name} (in process) over {n_batches} batches: launches {served[name]}; scores vs the f32 "
                      f"--fast chain max abs {d:.3e} (tolerance {W8A8_SCORE_ATOL})")
        require(got.shape == (CLI_UTTS,) and np.isfinite(got).all() and d <= W8A8_SCORE_ATOL, f"{name}: {d}")
    w8a8_launches = served["w8a8 f32"]["conv_block_w8a8"]
    b1_launches = served["w8a8 f32"]["block1_w8a8"]

    # -- the kernels against their plain versions at the serving shapes, from a batch of the chain
    feats = torch.randn(F32_CORPUS // BATCH, BATCH, features, N_FRAMES, device=dev, generator=gen)  # stored (F, T)
    f8 = w8.fold_cnn2d_w8a8({k: v.to(dev) for k, v in sds["cnn2d"].items()}, feats[0].cpu().numpy())
    x1 = feats[0].transpose(1, 2)  # the chain's (B, T, F) view of a stored batch
    b1_args = {dt: (x1.to(dt), f8["w1"], f8["b1"], f8["inv_s1"], dt) for dt in (torch.float32, torch.bfloat16)}
    b1_err = 0
    for dt, args in b1_args.items():
        got = block1_w8a8(*args)
        torch.cuda.synchronize()
        want = reference_block1_w8a8(*args)
        d = (got.int() - want.int()).abs()
        err, moved = int(d.max()), float((d > 0).float().mean())
        exact = dt == torch.float32
        phase("int8", f"block1_w8a8 {str(dt)[6:]} x{tuple(args[0].shape)} (a transposed view) -> {tuple(got.shape)} "
                      f"int8: codes moved at {moved!r} of positions, by at most {err} (tolerance: "
                      f"{'bit for bit' if exact else f'one step at <= {W8A8_MAX_MOVED} of positions'})")
        require(torch.equal(got, want) if exact else err <= 1 and moved <= W8A8_MAX_MOVED,
                f"block1_w8a8 {dt}: moved {moved}, max {err}")
        require(torch.equal(block1_w8a8(*args), got), "block1_w8a8: a second call differs")
        b1_err = max(b1_err, err) if exact else b1_err
        del got, want, d
    q1 = block1_w8a8(*b1_args[torch.float32])
    blocks = [(q1, f8["w2q"], f8["deq2"], f8["b2"], f8["inv_s2"], False)]
    blocks.append((conv_block_w8a8(*blocks[0]), f8["w3q"], f8["deq3"], f8["b3"], None, True))  # the chain's mean
    f32_mode = (*blocks[1][:5], False)  # block 3's f32 mode, off the chain
    odd = (q1[:, : q1.shape[1] - 1].contiguous(), *blocks[0][1:])  # an odd H: 159 conv rows
    w8_err = 0.0
    for args in (*blocks, f32_mode, odd):
        got = conv_block_w8a8(*args)
        torch.cuda.synchronize()
        want = reference_conv_block_w8a8(*args)
        err = float((got.float() - want.float()).abs().max())
        w8_err = max(w8_err, err)
        phase("int8", f"conv_block_w8a8 {w8a8_mode(args)} x{tuple(args[0].shape)} -> {tuple(got.shape)} "
                      f"{str(got.dtype)[6:]}: max abs against the plain version {err!r}")
        require(torch.equal(got, want), f"conv_block_w8a8 {w8a8_mode(args)} x{tuple(args[0].shape)}: not bit for bit")
        require(torch.equal(conv_block_w8a8(*args), got), "conv_block_w8a8: a second call differs")
        del got, want
    del odd
    phase("int8", "conv_block_w8a8: bit for bit at both serving shapes (int8 pooled, mean), block 3's f32 mode and "
                  "an odd H; a second call equal")

    # -- each block's ms in turns and on the device, its bound, and a control
    b1_entry = {}
    for dt, args in b1_args.items():
        x = args[0]
        ops = 2 * BATCH * 2 * (N_FRAMES // 2) * features * 32 * 9  # the conv rows the pool keeps
        bnd = bound(x.numel() * x.element_size() + 10 * 32 * 4 + BATCH * (N_FRAMES // 2) * features * 32,
                    **{"f32" if dt == torch.float32 else "bf16": ops})
        ms, plain_ms = in_turns(lambda: reference_block1_w8a8(*args), lambda: block1_w8a8(*args), reps=5)
        dev_ms, dev_how = device_ms(lambda: block1_w8a8(*args), "block1_w8a8")
        xc = x[:, None].float()
        wc = args[1].to(dt).float().permute(3, 2, 0, 1)
        conv_ms = statistics.mean(cuda_ms(lambda: torch.nn.functional.conv2d(xc, wc, padding=1), 10) for _ in range(2))
        phase("timing", f"block1_w8a8 {str(dt)[6:]} x{tuple(x.shape)} -> 32 int8 pooled: kernel {ms:.4f} ms in turns, "
                        f"device {dev_ms:.4f} ms a launch ({dev_how}), bound {bnd[0]:.4f} ms ({bnd[1]}), "
                        f"{bnd[0] / dev_ms:.1%} of the bound's rate on the device; plain {plain_ms:.4f} ms; no "
                        f"PyTorch call computes it (cuDNN's f32 conv alone, TF32 off, writes the "
                        f"{xc.numel() * 32 * 4 / 1e6:.1f} MB f32 rows and computes less: {conv_ms:.4f} ms), on {card}")
        if dt == torch.float32:  # the main path's run above is f32
            b1_entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
        del xc
    w8_ms = w8_plain = w8_lib = 0.0
    w8_parts = []
    for i, (x, w, deq, b, inv_s, mean) in enumerate(blocks, 2):
        batch, h, width, c_in = x.shape
        c_out = w.shape[-1]
        conv_rows = 2 * (h // 2) if inv_s is not None else h  # the pool drops an odd last row
        ops = 2 * batch * conv_rows * width * c_out * 9 * c_in
        f32_bytes = batch * h * width * c_out * 4
        out_bytes = batch * (h // 2) * width * c_out if inv_s is not None else batch * width * c_out * 4
        bnd = bound(x.numel() + w.numel() + 8 * c_out + out_bytes, int8=ops)
        w8_parts.append(bnd)
        ms, plain_ms = in_turns(lambda: reference_conv_block_w8a8(x, w, deq, b, inv_s, mean),
                                lambda: conv_block_w8a8(x, w, deq, b, inv_s, mean), reps=5)
        dev_ms, dev_how = device_ms(lambda: conv_block_w8a8(x, w, deq, b, inv_s, mean), "conv_block_w8a8")
        if mean:  # the f32 mode beside it: the write the mean replaced, and the bound it had
            f32_ms, _ = device_ms(lambda: conv_block_w8a8(x, w, deq, b), "conv_block_w8a8")
            old = bound(x.numel() + w.numel() + 8 * c_out + f32_bytes, int8=ops)
            phase("timing", f"conv_block_w8a8 block 3 f32 mode (off the chain): device {f32_ms:.4f} ms a launch, "
                            f"its bound {old[0]:.4f} ms ({old[1]}: the {f32_bytes / 1e6:.1f} MB f32 write), "
                            f"{old[0] / f32_ms:.1%}; the mean mode writes {out_bytes / 1e6:.1f} MB, so its bound is "
                            f"{bnd[0]:.4f} ms ({bnd[1]}), on {card}")
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        patches = torch.cat([xp[:, dy:dy + h, dx:dx + width] for dy in range(3) for dx in range(3)], -1)
        patches = patches.reshape(-1, 9 * c_in)
        wm = w.reshape(9 * c_in, c_out).contiguous()
        del xp
        lib_ms = statistics.mean(cuda_ms(lambda: torch._int_mm(patches, wm), 10) for _ in range(2))
        del patches
        w8_ms, w8_plain, w8_lib = w8_ms + ms, w8_plain + plain_ms, w8_lib + lib_ms
        phase("timing", f"conv_block_w8a8 block {i} x{tuple(x.shape)} -> {c_out} {w8a8_mode((x, w, deq, b, inv_s, mean))}: "
                        f"kernel {ms:.4f} ms in turns, device "
                        f"{dev_ms:.4f} ms a launch ({dev_how}), bound {bnd[0]:.4f} ms ({bnd[1]}), "
                        f"{bnd[0] / dev_ms:.1%} of the bound's rate on the device; plain {plain_ms:.4f} ms; control "
                        f"torch._int_mm over the 9-tap "
                        f"patch matrix ({batch * h * width} x {9 * c_in} int8, no epilogue; computes less) "
                        f"{lib_ms:.4f} ms, on {card}")
    w8_bound = bound_sum(w8_parts)

    # -- chain rates: w8a8 against K2's f32 and bf16 chains, and one profile of the w8a8 chain
    f2 = {k: v.to(dev) for k, v in fast_infer.fold_cnn2d(sds["cnn2d"]).items()}
    chains = {
        "w8a8 f32": lambda f: w8.cnn2d_w8a8_scores(f8, f, compute_dtype=torch.float32),
        "w8a8 bf16": lambda f: w8.cnn2d_w8a8_scores(f8, f, compute_dtype=torch.bfloat16),
        "K2 f32 (predict --fast)": lambda f: fast_infer.cnn2d_fast_scores(f2, f, compute_dtype=torch.float32),
        "K2 bf16 (predict --fast --bf16)": lambda f: fast_infer.cnn2d_fast_scores(f2, f),
    }
    n_runs = (chain_rates.REPS + 1) * (F32_CORPUS // BATCH)
    for name, score in chains.items():
        _build.reset_launch_counts()
        r = chain_rates.rates(chain_rates.runner(score, feats), F32_CORPUS)
        timed = _build.launch_counts()
        per = W8A8_PER_BATCH if name.startswith("w8a8") else {"conv_block": 3}
        require(timed == {**dict.fromkeys(timed, 0), **{k: n * n_runs for k, n in per.items()}},
                f"{name} timed runs' launches: {timed}")
        phase("int8", chain_rates.summary(name, r) + f", {F32_CORPUS} feature tensors ({features} x {N_FRAMES}) at "
                                                     f"B={BATCH}, on {card}")
    for name in ("w8a8 f32", "w8a8 bf16"):
        profile_path(f"{name} B={BATCH}", chain_rates.runner(chains[name], feats), F32_CORPUS // BATCH, dev)
    del feats, blocks, q1, b1_args, x1

    # -- anomaly embeddings on the card against the CPU eval model
    emb_ds = rows(ds, 0, EMBED_UTTS)
    t0 = time.perf_counter()
    emb = anomaly.extract_embeddings(models["cnn2d"], emb_ds, BATCH)
    emb_cpu = anomaly.extract_embeddings(copy.deepcopy(models["cnn2d"]).cpu(), emb_ds, BATCH)
    d = float(np.abs(emb - emb_cpu).max())
    phase("int8", f"anomaly embeddings {emb.shape} on the card vs the CPU eval model: max abs {d:.3e} (tolerance "
                  f"{EMBED_ATOL}), {time.perf_counter() - t0:.1f}s")
    require(emb.shape == (EMBED_UTTS, 128 * features) and d <= EMBED_ATOL, f"embeddings: {emb.shape}, {d}")
    try:
        import sklearn  # noqa: F401
    except ImportError:
        phase("int8", "anomaly OC-SVM / GMM fits: not run (scikit-learn is not installed here; the CPU tests "
                      "cover them)")
    else:
        rep = anomaly.embedding_anomaly_report(models["cnn2d"], emb_ds, emb_ds, BATCH)
        phase("int8", f"anomaly report: OC-SVM EER {rep['ocsvm']['eer']!r}, GMM EER {rep['gmm']['eer']!r}")

    # -- the CLIs, as subprocesses: predict's int8 variants, the data tools, train --profile-dir
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cli = [sys.executable, "-m"]
    with tempfile.TemporaryDirectory(prefix="dfac_smoke_int8_") as tmp:
        fpath, lpath = write_split(tmp, "all", ds)
        store = os.path.join(tmp, "store")
        save_npy_dataset(ds, store)
        small = {k: write_split(tmp, k, rows(ds, a, b))
                 for k, (a, b) in (("train", (0, INT8_TRAIN_UTTS)), ("dev", (INT8_TRAIN_UTTS, 2 * INT8_TRAIN_UTTS)))}
        ck = {k: os.path.join(tmp, f"{k}.ckpt") for k in sds}
        for k, sd in sds.items():
            save_checkpoint(ck[k], jax_from_state_dict(sd, k), config={"model": k})
        pred = os.path.join(tmp, "f32.pkl")
        write_predictions(pred, ds.uttids, f32_ref["cnn2d"])
        sub = generate_submission(fpath, pred, "S0", "Smoke", "Int8", "card", output_dir=tmp)
        outs = {k: os.path.join(tmp, f"{k.replace(' ', '_')}.pkl") for k in PREDICT_INT8}
        commands = {}
        for label, (model, on_store, flags) in PREDICT_INT8.items():
            commands[f"predict {label}"] = [
                *cli, "dfac_tpu_torch.cli.predict", "--features", store if on_store else fpath, "--checkpoint",
                ck[model], "--model", model, "--fast", *flags, "--out", outs[label], "--device", dev.type,
                "--in-features", str(features)]
        tools = [*cli, "dfac_tpu_torch.cli.data_tools"]
        npy_out = os.path.join(tmp, "bona_store")
        commands.update({
            "data_tools analyze-pickles": [*tools, "analyze-pickles", fpath, lpath],
            "data_tools check-shape": [*tools, "check-shape", fpath],
            "data_tools score-distributions": [*tools, "score-distributions", pred],
            "data_tools submission-stats": [*tools, "submission-stats", sub],
            "data_tools convert-to-npy": [*tools, "convert-to-npy", fpath, npy_out, "--labels", lpath,
                                          "--filter-label", "1"],
            "train --profile-dir": [*cli, "dfac_tpu_torch.cli.train", "--train-features", small["train"][0],
                                    "--train-labels", small["train"][1], "--dev-features", small["dev"][0],
                                    "--dev-labels", small["dev"][1], "--epochs", "1", "--batch-size",
                                    str(TRAIN_BATCH), "--quiet", "--checkpoint-dir", os.path.join(tmp, "ck"),
                                    "--profile-dir", os.path.join(tmp, "prof"), "--device", dev.type,
                                    "--in-features", str(features)],
        })
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cli_out = run_all(commands, env)
        phase("int8", f"{len(commands)} CLIs (concurrent): {time.perf_counter() - t0:.1f}s")
        for label, out in cli_out.items():
            for line in out.strip().splitlines():
                phase("int8", f"cli {label}: {line}")
        for label, (model, _, _) in PREDICT_INT8.items():
            got = pd.read_pickle(outs[label])
            require(got["uttid"].tolist() == ds.uttids, f"predict {label}: uttids")
            d = float(np.abs(got["predictions"].to_numpy() - f32_ref[model]).max())
            phase("int8", f"CLI predict {label} vs the f32 --fast chain ({model}): max abs {d:.3e} (tolerance "
                          f"{W8A8_SCORE_ATOL})")
            require(d <= W8A8_SCORE_ATOL, f"predict {label}: {d}")
        shape_out = cli_out["data_tools check-shape"]
        require(f"Shape: ({features}, {N_FRAMES})" in shape_out and "Dtype: float32" in shape_out, shape_out)
        require("protocol:" in cli_out["data_tools analyze-pickles"], "analyze-pickles: no report")
        require(len(cli_out["data_tools score-distributions"].strip().splitlines()) == 2, "score-distributions")
        n1 = int((f32_ref["cnn2d"] > 0.5).sum())
        require(f"Class 1 count: {n1}" in cli_out["data_tools submission-stats"], "submission-stats")
        bona = load_npy_dataset(npy_out)
        require(len(bona) == CLI_UTTS // 2 and (np.asarray(bona.labels) == 1).all()
                and np.array_equal(np.asarray(bona.features), ds.features[ds.labels == 1]),
                "convert-to-npy --filter-label 1: the store does not hold the bonafide rows")
        require(os.path.exists(os.path.join(tmp, "ck", "cnn2d_best.ckpt")), "train --profile-dir: no checkpoint")
        (trace_file,) = os.listdir(os.path.join(tmp, "prof"))
        with open(os.path.join(tmp, "prof", trace_file)) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        phase("int8", f"train --profile-dir: {trace_file}, {len(events)} events, {kernels} CUDA kernel events")
        require(kernels > 0, "train --profile-dir: the trace holds no CUDA kernel event")

        # -- the host quantizer against the bf16 cast, and int8 against bf16 ingest end to end from a store
        big = os.path.join(tmp, "big_store")
        save_npy_dataset(rates.synthetic_dataset(INT8_STORE_UTTS, features, N_FRAMES, 21), big)
        big_ds = load_npy_dataset(big)
        host = np.ascontiguousarray(big_ds.features[:BATCH])
        for name, fn in (("cast_bf16", fastcast.cast_bf16), ("quant_i8", fastcast.quant_i8)):
            fn(host)
            ms = []
            for _ in range(7):
                t0 = time.perf_counter()
                fn(host)
                ms.append((time.perf_counter() - t0) * 1e3)
            phase("int8", f"host {name} of a batch of {BATCH} ({host.nbytes / 1e6:.1f} MB f32): "
                          f"{statistics.median(ms):.4f} ms (median of 7; min {min(ms):.4f}, max {max(ms):.4f}), "
                          f"{torch.get_num_threads()} threads")
        e2e = {}
        for ingest_int8 in (False, True, True, False):
            stats = PrefetchStats()
            t0 = time.perf_counter()
            fast_infer.predict_scores_fast(sds["cnn2d"], big_ds, dev, BATCH, stats=stats, ingest_int8=ingest_int8)
            dt = time.perf_counter() - t0
            e2e.setdefault(ingest_int8, []).append(INT8_STORE_UTTS / dt)
            phase("int8", f"predict_scores_fast bf16 from a {INT8_STORE_UTTS}-utterance store, "
                          f"{'int8' if ingest_int8 else 'bf16'} ingest: {INT8_STORE_UTTS / dt:.1f} utt/s (host-wait "
                          f"{stats.host_wait_s:.3f}s, device-wait {stats.device_wait_s:.3f}s), on {card}")
    phase("int8", f"end to end, bf16 ingest {e2e[False]} against int8 ingest {e2e[True]} utt/s")
    src = "dfac_tpu_torch/csrc/conv_block_w8a8.cu"
    return [{"name": "conv_block_w8a8", "route": "cuda", "source": src,
             "replaces": "dfac_tpu/models/fast_infer_int8.py:188 (an XLA int8 conv; no Pallas counterpart)",
             "launches": w8a8_launches, "max_abs_err": w8_err, "ms": w8_ms, "plain_ms": w8_plain,
             "bound_ms": w8_bound[0], "bound_by": w8_bound[1], "library_ms": w8_lib},
            {"name": "block1_w8a8", "route": "cuda", "source": src,
             "replaces": "dfac_tpu/models/fast_infer_int8.py:180 (an XLA conv and epilogue; no Pallas counterpart)",
             "launches": b1_launches, "max_abs_err": float(b1_err), **b1_entry, "library_ms": None}]


def train_rest_phase(dev, card: str) -> None:
    """Phase 20: chunked streaming, the fused fits and the BatchNorm freeze tail (see the module docstring)."""
    import pandas as pd
    import torch

    from dfac_tpu_torch.models import build_model
    from dfac_tpu_torch.models.fast_infer import predict_scores_fast
    from dfac_tpu_torch.ops import _build
    from dfac_tpu_torch.train import rates
    from dfac_tpu_torch.train.checkpoint import load_model_variables
    from dfac_tpu_torch.train.detector_loop import DetectorConfig, DetectorTrainer
    from dfac_tpu_torch.train.evaluate import predict_scores
    from dfac_tpu_torch.train.loop import TrainConfig, Trainer

    features = TRAIN_FEATURES
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cli = [sys.executable, "-m"]

    def bn_stats(state: dict) -> dict:
        return {k: v.detach().clone() for k, v in state.items() if "running" in k or "num_batches" in k}

    def close(a, b) -> bool:
        return bool(np.allclose(a, b, rtol=REST_RTOL, atol=0.0))

    def cnn2d_cfg(**kw):
        return TrainConfig(**{**dict(batch_size=TRAIN_BATCH, epochs=REST_EPOCHS, in_features=features, seed=SEED,
                                     label_smoothing=0.05, lr_scheduler="plateau", lr_scheduler_patience=0,
                                     early_stop=2), **kw})

    def det_cfg(**kw):
        return DetectorConfig(**{**dict(batch_size=TRAIN_BATCH, epochs=REST_EPOCHS, hidden=DETECTOR_HIDDEN, ema=True,
                                        specaug=True, patience=1, seed=SEED), **kw})

    def best_epoch(history) -> int:
        return max(m.epoch for m in history if m.is_best)

    _build.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="dfac_smoke_rest_") as tmp:
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ck")
        splits = {name: alt_dataset(n, 50 + i) for i, (name, n) in enumerate(REST_CLI_UTTS.items())}
        paths = {name: write_split(data, name, ds) for name, ds in splits.items()}
        train_ds, dev_ds = splits["train"], splits["dev"]
        # -- the six CLIs, started now and collected after the checks in process below
        common = ["--batch-size", str(TRAIN_BATCH), "--epochs", "2", "--device", dev.type]
        split_flags = ["--train-features", paths["train"][0], "--train-labels", paths["train"][1],
                       "--dev-features", paths["dev"][0], "--dev-labels", paths["dev"][1]]
        train = [*cli, "dfac_tpu_torch.cli.train", *split_flags, *common, "--in-features", str(features), "--no-rich"]
        cae = [*cli, "dfac_tpu_torch.cli.train_cae", *split_flags, *common, "--base-channels", str(CAE_BASE),
               "--no-rich"]
        det = [*cli, "dfac_tpu_torch.cli.train_detector", "--data-dir", data, *common, "--hidden",
               str(DETECTOR_HIDDEN)]
        chunk = ["--resident-chunk-batches", str(REST_CHUNK)]
        runs = {
            "train --resident-chunk-batches 4 --chunk-ingest int8 --train-fast":
                train + ["--checkpoint-dir", os.path.join(ck, "chunked"), *chunk, "--chunk-ingest", "int8",
                         "--train-fast"],
            "train --fused-fit": train + ["--checkpoint-dir", os.path.join(ck, "fused"), "--fused-fit"],
            "train_cae --fused-fit --train-fast":
                cae + ["--checkpoint-dir", os.path.join(ck, "cae_fused"), "--fused-fit", "--train-fast"],
            "train_cae --resident-chunk-batches 4 --chunk-ingest bf16":
                cae + ["--checkpoint-dir", os.path.join(ck, "cae_chunked"), *chunk, "--chunk-ingest", "bf16"],
            "train_detector --fused-fit --train-fast --ema":
                det + ["--ckpt-path", os.path.join(ck, "det_fused.ckpt"), "--prediction-pkl",
                       os.path.join(tmp, "det_fused.pkl"), "--fused-fit", "--train-fast", "--ema"],
            "train_detector --resident-chunk-batches 4":
                det + ["--ckpt-path", os.path.join(ck, "det_chunked.ckpt"), "--prediction-pkl",
                       os.path.join(tmp, "det_chunked.pkl"), *chunk],
        }
        t_cli = time.perf_counter()
        procs = start_all(runs, env)

        # -- fit_fused against the per-epoch resident fit at B=32 (correctness; the CLIs share the card). cuDNN's
        # deterministic algorithms for these four fits: with its default ones two per-epoch fits part by 2e-3 in
        # the dev loss within 3 epochs on the card, where the fused and per-epoch fits then agree bit for bit
        torch.backends.cudnn.deterministic = True
        ref_t, got_t = Trainer(cnn2d_cfg(device_resident=True), device=dev), Trainer(cnn2d_cfg(), device=dev)
        ref, got = ref_t.fit(train_ds, dev_ds), got_t.fit_fused(train_ds, dev_ds)

        def rows(history):
            return [(m.train_loss, m.dev_loss, m.dev_eer, m.learning_rate) for m in history]

        require(len(got["history"]) == len(ref["history"]) and close(rows(got["history"]), rows(ref["history"])),
                f"CNN2D fused {rows(got['history'])} vs per-epoch {rows(ref['history'])}")
        require(got["best_epoch"] == best_epoch(ref["history"]), f"best epochs {got['best_epoch']} / {ref['history']}")
        bs_got, bs_ref = bn_stats(got_t.best_variables()), bn_stats(ref_t.best_variables())
        require(all(np.allclose(bs_got[k].cpu(), bs_ref[k].cpu(), rtol=REST_RTOL, atol=1e-5) for k in bs_ref),
                "the fused best snapshot's BatchNorm statistics are not the best epoch's")
        same = rows(got["history"]) == rows(ref["history"])
        phase("train-rest", f"CNN2D fit_fused vs per-epoch resident fit, B={TRAIN_BATCH}, {len(train_ds)} / "
                            f"{len(dev_ds)} utterances, plateau and early stop, cuDNN deterministic: "
                            f"history (train loss, dev loss, EER, lr) {rows(got['history'])} vs "
                            f"{rows(ref['history'])} ({'equal' if same else f'rtol {REST_RTOL}'}); best epoch "
                            f"{got['best_epoch']} both; the best snapshot's BatchNorm statistics the best epoch's")
        det_ref_t = DetectorTrainer(det_cfg(device_resident=True), in_channels=features, device=dev)
        det_got_t = DetectorTrainer(det_cfg(), in_channels=features, device=dev)
        det_ref = det_ref_t.fit(train_ds, dev_ds, ckpt_path=os.path.join(tmp, "det_ref.ckpt"))
        det_got = det_got_t.fit_fused(train_ds, dev_ds, ckpt_path=os.path.join(tmp, "det_got.ckpt"))
        torch.backends.cudnn.deterministic = False
        h_ref = [(h["train_loss"], h["dev_eer"]) for h in det_ref["history"]]
        h_got = [(h["train_loss"], h["dev_eer"]) for h in det_got["history"]]
        require(len(h_got) == len(h_ref) and close(h_got, h_ref), f"detector fused {h_got} vs per-epoch {h_ref}")
        ck_ref, ck_got = (load_model_variables(os.path.join(tmp, f"det_{n}.ckpt"), "detector") for n in ("ref", "got"))
        require(all(np.allclose(ck_got[k], ck_ref[k], rtol=REST_RTOL, atol=1e-5) for k in bn_stats(ck_ref)),
                "the detector's best checkpoints hold other BatchNorm statistics")
        phase("train-rest", f"detector fit_fused vs per-epoch resident fit, B={TRAIN_BATCH}, EMA, SpecAugment, "
                            f"patience 1, cuDNN deterministic: history (train loss, dev EER) {h_got} vs {h_ref} "
                            f"({'equal' if h_got == h_ref else f'rtol {REST_RTOL}'}); best "
                            f"dev EER {det_got['best_eer']!r} / {det_ref['best_eer']!r}; the best checkpoints' "
                            f"BatchNorm statistics agree")
        del ref_t, got_t, det_ref_t, det_got_t

        # -- the freeze boundary: epoch 3 of 3 at frac 0.5 (round(1.5) = 2) leaves the statistics as they were
        for label, kw in (("resident", dict(device_resident=True)), ("chunked f32", dict(resident_chunk_batches=4))):
            t = Trainer(cnn2d_cfg(bn_freeze_after_frac=0.5, early_stop=0, **kw), device=dev)
            t.init_state(example_batch=train_ds.features[:1])
            t.train_epoch(train_ds, 1)
            t.train_epoch(train_ds, 2)
            before, params = bn_stats(t.model.state_dict()), t.model.conv[0].weight.detach().clone()
            t.train_epoch(train_ds, 3)
            after = bn_stats(t.model.state_dict())
            require(all(torch.equal(after[k], v) for k, v in before.items()), f"{label}: epoch 3 moved the statistics")
            require(not torch.equal(params, t.model.conv[0].weight), f"{label}: epoch 3 trained nothing")
            phase("train-rest", f"freeze tail, CNN2D {label} B={TRAIN_BATCH}: epoch 3 of 3 at frac 0.5 leaves the "
                                f"{len(before)} BatchNorm buffers bit for bit, conv1 trains on")
        for name, t in (
                ("CNN2D", Trainer(cnn2d_cfg(bn_freeze_after_frac=1e-9, early_stop=0), device=dev)),
                ("detector", DetectorTrainer(det_cfg(bn_freeze_after_frac=1e-9, patience=REST_EPOCHS),
                                             in_channels=features, device=dev))):
            t.fit_fused(train_ds, dev_ds)
            for k, v in bn_stats(t.model.state_dict()).items():
                want = 1.0 if "running_var" in k else 0.0
                require(bool((v == want).all()), f"fused {name}: {k} left its init")
            phase("train-rest", f"freeze tail, {name} fit_fused with every epoch frozen: every BatchNorm buffer at its "
                                f"init, bit for bit")

        # -- the CLIs
        outs = finish_all(procs)
        phase("train-rest", f"{len(runs)} CLIs (concurrent, 2 epochs at B={TRAIN_BATCH}, {len(train_ds)} / "
                            f"{len(dev_ds)} utterances, beside the checks above): {time.perf_counter() - t_cli:.1f}s")
        for label, out in outs.items():
            for line in out.strip().splitlines():
                phase("train-rest", f"cli {label}: {line}")
            if label.startswith("train "):
                run_dir = os.path.join(ck, "chunked" if "chunk" in label else "fused")
                for kind in ("best", "last"):
                    require(os.path.exists(os.path.join(run_dir, f"cnn2d_{kind}.ckpt")), f"{label}: no {kind} ckpt")
                require(re.search(r"^best dev EER: ", out, re.M), f"{label}: no final line")
                losses = epoch_losses(out)
                require(len(losses) == (0 if "fused" in label else 2) and np.isfinite(losses).all(),
                        f"{label}: epoch lines {losses}")
            elif label.startswith("train_cae"):
                run_dir = os.path.join(ck, "cae_fused" if "fused" in label else "cae_chunked")
                for name in ("cae_best.ckpt", "cae_last.ckpt", "normalizer.npz"):
                    require(os.path.exists(os.path.join(run_dir, name)), f"{label}: no {name}")
                mse = float(re.search(r"^best val reconstruction MSE: (\S+)$", out, re.M).group(1))
                require(np.isfinite(mse) and mse > 0, f"{label}: {mse}")
            else:
                require(re.search(r"^Training done\. Best dev EER: ", out, re.M), f"{label}: no training line")
                require(re.search(r"^EER on split 'test2': ", out, re.M), f"{label}: no test2 EER")
                pred = pd.read_pickle(os.path.join(tmp, "det_fused.pkl" if "fused" in label else "det_chunked.pkl"))
                require(len(pred) == REST_CLI_UTTS["test2"] and np.isfinite(pred["predictions"]).all(), f"{label}")

        # -- the chunk-trained CNN2D checkpoint served as predict --fast (f32) and predict serve it
        best = os.path.join(ck, "chunked", "cnn2d_best.ckpt")
        model = build_model("cnn2d", in_features=features)
        model.load_state_dict(load_model_variables(best))
        trained = _build.launch_counts()
        _build.reset_launch_counts()
        fast = predict_scores_fast(model.state_dict(), dev_ds, dev, batch_size=BATCH, compute_dtype=torch.float32)
        served = _build.launch_counts()
        n_served = -(-len(dev_ds) // BATCH)
        require(served == {**dict.fromkeys(served, 0), "conv_block": 3 * n_served}, f"served: {served}")
        plain = predict_scores(model.to(dev), dev_ds, batch_size=BATCH, apply_sigmoid=True)
        d_in = float(np.abs(fast - plain).max())
        phase("train-rest", f"the chunk-trained (int8 ingest, --train-fast) CNN2D's best checkpoint: "
                            f"predict_scores_fast (predict --fast, K2 f32) vs predict_scores (predict) on "
                            f"{len(dev_ds)} utterances: max abs {d_in:.3e} (tolerance {F32_SCORE_ATOL}), launches over "
                            f"{n_served} batches {served}")
        require(d_in <= F32_SCORE_ATOL, "predict and predict --fast disagree")
        require(not any(trained.values()), f"training launched kernels of the port: {trained}")

    # -- timing, alone on the card: the chunked feed per ingest mode beside the resident epoch
    _build.reset_launch_counts()
    for b, n in ((REST_BIG_BATCH, REST_UTTS), (TRAIN_BATCH, REST_SMALL_UTTS)):
        ds = rates.synthetic_dataset(n, features, N_FRAMES, 60)
        steps = n // b
        losses = {}
        for mode in ("resident", "f32", "bf16", "int8"):
            kw = dict(device_resident=True) if mode == "resident" else dict(resident_chunk_batches=REST_CHUNK,
                                                                            chunk_ingest=mode)
            t = Trainer(TrainConfig(batch_size=b, in_features=features, seed=SEED, label_smoothing=0.05, **kw),
                        device=dev)
            t.init_state(example_batch=ds.features[:1])
            losses[mode], wait = [], []

            def run(i, t=t, mode=mode, wait=wait):
                losses[mode].append(t.train_epoch(ds, 1 + i))
                wait.append(t.chunk_feed.stats.host_wait_s if t.chunk_feed.stats is not None else 0.0)

            secs = rates.run_seconds(run, reps=REST_REPS)
            ms = [1e3 * s / steps for s in secs]
            utt = [n / s for s in secs]
            waited = [w / s for w, s in zip(wait[1:], secs)]
            require(np.isfinite(losses[mode]).all(), f"B={b} {mode}: losses {losses[mode]}")
            phase("train-rest", f"CNN2D B={b} {'resident' if mode == 'resident' else f'chunked G={REST_CHUNK} {mode}'}"
                                f" on {n} utterances: {statistics.median(ms):.4f} ms a step (median of {len(ms)} "
                                f"epochs of {steps} steps; min {min(ms):.4f}, max {max(ms):.4f}), "
                                f"{statistics.median(utt):.1f} utt/s (min {min(utt):.1f}, max {max(utt):.1f}), "
                                f"host-wait {statistics.median(waited):.1%} of the epoch (max {max(waited):.1%}); "
                                f"losses {losses[mode]}, on {card}")
            del t
            torch.cuda.empty_cache()
        require(close(losses["f32"], losses["resident"]),
                f"B={b} chunked f32 losses {losses['f32']} vs resident {losses['resident']}")
        del ds
    # -- fused against per-epoch, 3 epochs, host clock: a 1-epoch warm-up fit at each batch size (cuDNN's
    # autotuning and the allocator's first blocks), then the two in turns; one profiled fused detector run at B=32
    for b, n in ((TRAIN_BATCH, REST_CLI_UTTS["train"]), (REST_BIG_BATCH, REST_FUSED_BIG_UTTS)):
        tr, dv = rates.synthetic_dataset(n, features, N_FRAMES, 61), rates.synthetic_dataset(n // 4, features, N_FRAMES,
                                                                                             62)
        Trainer(cnn2d_cfg(batch_size=b, epochs=1, device_resident=True), device=dev).fit(tr, dv)
        walls = {"per-epoch": [], "fused": []}
        for kind in ("per-epoch", "fused", "fused", "per-epoch"):
            t = Trainer(cnn2d_cfg(batch_size=b, device_resident=True), device=dev)
            t.init_state(example_batch=tr.features[:1])
            t0 = time.perf_counter()
            (t.fit if kind == "per-epoch" else t.fit_fused)(tr, dv)
            walls[kind].append(time.perf_counter() - t0)
            del t
        phase("train-rest", f"CNN2D fit B={b}, {REST_EPOCHS} epochs on {n} / {n // 4} utterances, after a warm-up fit: "
                            f"per-epoch resident {', '.join(f'{w:.3f}' for w in walls['per-epoch'])} s, fused "
                            f"{', '.join(f'{w:.3f}' for w in walls['fused'])} s (in turns: per-epoch, fused, fused, "
                            f"per-epoch), on {card}")
        torch.cuda.empty_cache()
    tr, dv = train_ds, dev_ds
    t = DetectorTrainer(det_cfg(patience=REST_EPOCHS), in_channels=features, device=dev)
    t.init_state()
    walls = []
    for _ in range(3):  # the first run uploads the corpus (kept by the trainer) and warms cuDNN
        t0 = time.perf_counter()
        t.fit_fused(tr, dv)
        walls.append(time.perf_counter() - t0)
    # a fourth run on the same trainer traced with CUDA activity only (recording the CPU-side ops as well lengthens
    # this launch-bound run's wall ~7x, the trace alone ~2x); busy: the union of its kernel and copy intervals over
    # its own wall, and over the untraced warm runs' wall (the same work)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_TRIES):  # the profiler has been seen to drop a whole pass's device records
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t.fit_fused(tr, dv)
        traced = time.perf_counter() - t0
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
        if events:
            break
    if not events:
        phase("train-rest", f"detector fit_fused B={TRAIN_BATCH}: wall {', '.join(f'{w:.3f}' for w in walls)} s; "
                            f"device time and busy share not measured: torch.profiler recorded no device event in "
                            f"{PROFILER_TRIES} traced runs, on {card}")
    else:
        busy_us, end, per_name = 0.0, float("-inf"), {}
        for e in sorted(events, key=lambda e: e.time_range.start):
            a, b = e.time_range.start, e.time_range.end
            if b > end:
                busy_us += b - max(a, end)
                end = b
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + b - a, n + 1)
        steps = -(-len(tr) // TRAIN_BATCH) * REST_EPOCHS
        device_ms = sum(us for us, _ in per_name.values()) / 1e3
        phase("train-rest", f"detector fit_fused B={TRAIN_BATCH}, {REST_EPOCHS} epochs on {len(tr)} / "
                            f"{len(dv)} utterances: wall {', '.join(f'{w:.3f}' for w in walls)} s (the first "
                            f"uploads the corpus); the fourth traced (CUDA activity only): wall {traced:.3f} s, "
                            f"device {device_ms / steps:.4f} ms a step (kernels and copies, {steps} steps with the "
                            f"dev passes), busy {busy_us / 1e6 / traced:.1%} of the traced wall, "
                            f"{busy_us / 1e6 / statistics.median(walls[1:]):.1%} of the untraced warm runs' median "
                            f"wall, on {card}")
        for name, (us, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]:
            phase("train-rest", f"  {us / 1e3 / steps:8.4f} ms {us / 1e3 / device_ms:6.1%} {n / steps:5.1f}x  "
                                f"{name[:110]}")
    timed = _build.launch_counts()
    require(not any(timed.values()), f"the timed training runs launched kernels of the port: {timed}")
    phase("train-rest", f"launches over the timed training runs: {timed} (cuDNN and cuBLAS only)")


def dp_rank_step(kind: str, sd: dict, feats: np.ndarray, labels: np.ndarray) -> tuple[float, dict]:
    """Phase 21, on each of two gloo ranks sharing the card: one CNN2D DP
    step (SGD 0.1) on the rank's half of the global batch; the summed loss
    and the state afterwards (numpy)."""
    import torch

    from dfac_tpu_torch.parallel.data_parallel import rank_device
    from dfac_tpu_torch.train.loop import TrainConfig, Trainer

    dev = rank_device(kind)
    t = Trainer(TrainConfig(batch_size=len(feats), in_features=TRAIN_FEATURES, dropout=0.0, label_smoothing=0.05,
                            data_parallel=2), device=dev)
    t.init_state({k: torch.from_numpy(v) for k, v in sd.items()})
    t.optimizer = torch.optim.SGD(t.model.parameters(), lr=0.1)
    k, r = len(feats) // 2, t.ranks.rank
    x, y = (torch.from_numpy(a[r * k : (r + 1) * k]).to(dev) for a in (feats, labels))
    loss_sum, _ = t.train_step(x, y, torch.ones(k, device=dev))
    return float(loss_sum), {n: v.cpu().numpy() for n, v in t.model.state_dict().items()}


def data_parallel_phase(dev, card: str) -> None:
    """Phase 21: data-parallel training on the one card (see the module docstring)."""
    import datetime

    import torch
    import torch.distributed as dist

    from dfac_tpu_torch.models import build_model
    from dfac_tpu_torch.models.fast_infer import predict_scores_fast
    from dfac_tpu_torch.ops import _build
    from dfac_tpu_torch.parallel import data_parallel as dpar
    from dfac_tpu_torch.train import rates
    from dfac_tpu_torch.train.checkpoint import load_model_variables
    from dfac_tpu_torch.train.evaluate import predict_scores
    from dfac_tpu_torch.train.loop import TrainConfig, Trainer

    features = TRAIN_FEATURES
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))

    def cfg(**kw):
        return TrainConfig(**{**dict(batch_size=TRAIN_BATCH, epochs=2, in_features=features, seed=SEED,
                                     label_smoothing=0.05, lr_scheduler="plateau"), **kw})

    def rows(history):
        return [(m.train_loss, m.dev_loss, m.dev_eer, m.learning_rate) for m in history]

    with tempfile.TemporaryDirectory(prefix="dfac_smoke_dp_") as tmp:
        # the refused CLI and the two ranks on the one card start now, beside the work in process below
        tiny = write_split(tmp, "tiny", rates.synthetic_dataset(DP_CLI_UTTS, features, N_FRAMES, 80))
        refused = subprocess.Popen(
            [sys.executable, "-m", "dfac_tpu_torch.cli.train", "--train-features", tiny[0], "--train-labels", tiny[1],
             "--dev-features", tiny[0], "--dev-labels", tiny[1], "--data-parallel", "2", "--in-features",
             str(features), "--quiet", "--checkpoint-dir", os.path.join(tmp, "ck_refused")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
        t_pool = time.perf_counter()
        pool = dpar.RankPool([f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu"] * 2, backend="gloo",
                             timeout_s=DP_TIMEOUT_S)
        try:
            # -- one rank on NCCL, in this process
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                    init_method=f"tcp://127.0.0.1:{dpar.free_port()}", world_size=1, rank=0,
                                    timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
            try:
                group = dist.group.WORLD
                train_ds = rates.synthetic_dataset(TRAIN_UTTS, features, N_FRAMES, 81)
                dev_ds = rates.synthetic_dataset(TRAIN_DEV_UTTS, features, N_FRAMES, 82)
                _build.reset_launch_counts()
                torch.backends.cudnn.deterministic = True
                ck = os.path.join(tmp, "ck")
                t0 = time.perf_counter()
                single = Trainer(cfg(), device=dev).fit(train_ds, dev_ds)
                t1 = time.perf_counter()
                dp_t = Trainer(cfg(), device=dev, group=group)
                dp_fit = dp_t.fit(train_ds, dev_ds, checkpoint_dir=ck)
                t2 = time.perf_counter()
                torch.backends.cudnn.deterministic = False
                require(len(dp_fit["history"]) == len(single["history"]) == 2
                        and np.allclose(rows(dp_fit["history"]), rows(single["history"]), rtol=REST_RTOL, atol=0.0),
                        f"DP fit {rows(dp_fit['history'])} vs single-device {rows(single['history'])}")
                require(dp_fit["best_epoch"] == single["best_epoch"],
                        f"best epochs: DP {dp_fit['best_epoch']}, single-device {single['best_epoch']}")
                phase("data-parallel", f"one NCCL rank, CNN2D full width, B={TRAIN_BATCH}, 2 epochs on "
                                       f"{len(train_ds)} / {len(dev_ds)} utterances, cuDNN deterministic: DP fit "
                                       f"(train loss, dev loss, EER, lr) {rows(dp_fit['history'])} vs the "
                                       f"single-device host-fed fit {rows(single['history'])} (rtol {REST_RTOL}); "
                                       f"best epoch {dp_fit['best_epoch']} both; wall {t2 - t1:.2f} s vs "
                                       f"{t1 - t0:.2f} s")
                del dp_t
                # -- ms a step: the DP step (eager synced BatchNorm, the flat all-reduce) and the single-device one
                for b, steps in sorted(TRAIN_STEPS.items(), reverse=True):
                    ds = rates.synthetic_dataset(b * steps, features, N_FRAMES, 83)
                    trainers = {"single-device": Trainer(cfg(batch_size=b), device=dev),
                                "data-parallel": Trainer(cfg(batch_size=b), device=dev, group=group)}
                    for t in trainers.values():
                        t.init_state(example_batch=ds.features[:1])
                    secs = {k: [] for k in trainers}
                    for k in ("single-device", "data-parallel", "data-parallel", "single-device"):
                        secs[k] += rates.epoch_seconds(trainers[k], ds, reps=DP_REPS)
                    ms = {k: [1e3 * x / steps for x in v] for k, v in secs.items()}
                    med = {k: statistics.median(v) for k, v in ms.items()}
                    phase("data-parallel", f"train step B={b} host-fed, one NCCL rank: data-parallel "
                                           f"{med['data-parallel']:.4f} ms (min {min(ms['data-parallel']):.4f}, max "
                                           f"{max(ms['data-parallel']):.4f}) vs single-device "
                                           f"{med['single-device']:.4f} ms (min {min(ms['single-device']):.4f}, max "
                                           f"{max(ms['single-device']):.4f}): x"
                                           f"{med['data-parallel'] / med['single-device']:.3f} (median of "
                                           f"{len(ms['single-device'])} epochs of {steps} steps each, in turns "
                                           f"single, DP, DP, single), on {card}")
                    del trainers, ds
                    torch.cuda.empty_cache()
                trained = _build.launch_counts()
                require(not any(trained.values()), f"DP training launched kernels of the port: {trained}")
                # -- the DP-trained checkpoint served as predict --fast (f32) and predict serve it
                model = build_model("cnn2d", in_features=features)
                model.load_state_dict(load_model_variables(os.path.join(ck, "cnn2d_best.ckpt")))
                _build.reset_launch_counts()
                fast = predict_scores_fast(model.state_dict(), dev_ds, dev, batch_size=BATCH,
                                           compute_dtype=torch.float32)
                served = _build.launch_counts()
                n_served = -(-len(dev_ds) // BATCH)
                plain = predict_scores(model.to(dev), dev_ds, batch_size=BATCH, apply_sigmoid=True)
                d_in = float(np.abs(fast - plain).max())
                phase("data-parallel", f"the DP-trained CNN2D's best checkpoint: predict_scores_fast (predict --fast, "
                                       f"K2 f32) vs predict_scores on {len(dev_ds)} utterances: max abs {d_in:.3e} "
                                       f"(tolerance {F32_SCORE_ATOL}), launches over {n_served} batches {served}")
                require(served == {**dict.fromkeys(served, 0), "conv_block": 3 * n_served}, f"served: {served}")
                require(d_in <= F32_SCORE_ATOL, "predict and predict --fast disagree on the DP-trained checkpoint")
            finally:
                dist.destroy_process_group()

            # -- two gloo ranks sharing the card: one DP step against the single-device step
            batch = rates.synthetic_dataset(DP_STEP_BATCH, features, N_FRAMES, 84)
            feats, labels = batch.features, batch.labels.astype(np.float32)
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(SEED)
                sd = {k: v.numpy() for k, v in build_model("cnn2d", in_features=features, dropout=0.0)
                      .state_dict().items()}
            t0 = time.perf_counter()
            got = pool.run(dp_rank_step, dev.type, sd, feats, labels, timeout_s=DP_TIMEOUT_S)
            t_ranks = time.perf_counter() - t0
            one = Trainer(TrainConfig(batch_size=DP_STEP_BATCH, in_features=features, dropout=0.0,
                                      label_smoothing=0.05), device=dev)
            one.init_state({k: torch.from_numpy(v) for k, v in sd.items()})
            one.optimizer = torch.optim.SGD(one.model.parameters(), lr=0.1)
            loss_one, _ = one.train_step(torch.from_numpy(feats).to(dev), torch.from_numpy(labels).to(dev),
                                         torch.ones(DP_STEP_BATCH, device=dev))
            want = {k: v.cpu().numpy() for k, v in one.model.state_dict().items()}
            errs = {"loss": 0.0, "params": 0.0, "mean": 0.0, "var": 0.0}
            for loss, state in got:
                errs["loss"] = max(errs["loss"], abs(loss - float(loss_one)) / abs(float(loss_one)))
                for k, w in want.items():
                    kind = "mean" if "running_mean" in k else "var" if "running_var" in k else \
                        None if "num_batches" in k else "params"
                    if kind:
                        d = np.abs(state[k] - w) / (np.abs(w) if kind == "var" else 1.0)
                        errs[kind] = max(errs[kind], float(d.max()))
            phase("data-parallel", f"two gloo ranks sharing {card} (processes started with the phase, "
                                   f"{time.perf_counter() - t_pool:.1f} s ago): one CNN2D DP step, global B="
                                   f"{DP_STEP_BATCH}, SGD 0.1, against the single-device step on the concatenated "
                                   f"batch: loss sum rel {errs['loss']:.2e} (1e-5), parameters max abs "
                                   f"{errs['params']:.2e} (2e-6), BatchNorm mean max abs {errs['mean']:.2e} (1e-6), "
                                   f"var max rel {errs['var']:.2e} (1e-4); the step {t_ranks:.2f} s")
            require(errs["loss"] <= 1e-5 and errs["params"] <= 2e-6 and errs["mean"] <= 1e-6 and errs["var"] <= 1e-4,
                    f"the two-rank step disagrees with the single-device step: {errs}")
        finally:
            pool.close()
        # -- the CLI on a machine with one card
        out, err = refused.communicate(timeout=DP_TIMEOUT_S)
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        msg = f"mesh 2x1 needs 2 devices, only {n_cards} available"
        require(refused.returncode not in (0, None) and msg in err and not os.path.exists(os.path.join(tmp, "ck_refused")),
                f"train --data-parallel 2 exited {refused.returncode}: {err[-2000:]}")
        phase("data-parallel", f"train --data-parallel 2 on {n_cards} card(s): exit {refused.returncode}, "
                               f"{err.strip().splitlines()[-1]}")


def mh_waves(dev, seed: int, n: int, batch: int, frames: int):
    """Phase 22's waveforms, (n / batch, batch, the samples of ``frames``), drawn on ``dev`` from ``seed`` (the same
    in every process)."""
    import torch

    from dfac_tpu_torch.features.lfcc import LFCCConfig

    gen = torch.Generator(device=dev).manual_seed(seed)
    return 0.1 * torch.randn((n // batch, batch, LFCCConfig().num_samples(frames)), generator=gen, device=dev)


def mh_rank_serving(kind: str, sd: dict, feats, seed: int, batch: int) -> dict:
    """Phase 22, on each of two gloo ranks sharing the card: the sharded
    fast scorers on this rank's rows of every batch, gathered (the waveform
    corpus scorer, bf16, K1 and K2; ``predict --fast --data-parallel``'s
    f32 feature loop over ``feats``, K2), their launches, and each one's
    seconds per run (every run ends in the gather). The waveforms, as many
    as ``feats`` and as long as its frames, are drawn on the card from
    ``seed``; ``batch`` is the global batch."""
    import torch
    import torch.distributed as dist

    from dfac_tpu_torch.data.pipeline import ArrayDataset
    from dfac_tpu_torch.features.lfcc import LFCCConfig
    from dfac_tpu_torch.models.fast_infer import fold_cnn2d
    from dfac_tpu_torch.ops import _build
    from dfac_tpu_torch.parallel import multihost as mh
    from dfac_tpu_torch.parallel import serving
    from dfac_tpu_torch.parallel.data_parallel import Ranks, rank_device

    dev, ranks = rank_device(kind), Ranks.of()
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    folded = {k: v.to(dev) for k, v in fold_cnn2d(sd).items()}
    lo, hi = mh.local_row_range(ranks.world, ranks.rank, batch)
    waves = mh_waves(dev, seed, len(feats), batch, feats.shape[2])[:, lo:hi].contiguous()
    scorer = serving.make_sharded_fast_corpus_scorer(LFCCConfig(), "gemm", compute_dtype=torch.bfloat16)
    ds = ArrayDataset([str(i) for i in range(len(feats))], feats.numpy())
    runs = {
        "waves": lambda: mh.gather_rows(scorer(folded, waves), ranks, rows=hi - lo),
        "feats": lambda: serving.predict_scores_sharded(sd, ds, dev, ranks, batch, compute_dtype=torch.float32),
    }
    out = {}
    for name, run in runs.items():
        _build.reset_launch_counts()
        out[name] = run()
        out[f"{name} launches"] = _build.launch_counts()
        secs = []
        for _ in range(MH_RATE_REPS):
            dist.barrier()
            t0 = time.perf_counter()
            run()
            secs.append(time.perf_counter() - t0)
        out[f"{name} s"] = secs
    return out


def mh_rank_fit(argv: list) -> None:
    """Phase 22, on each of two gloo ranks sharing the card: ``train
    --data-parallel 2``'s fit of ``argv`` (cuDNN's deterministic algorithms,
    as the multi-host CLI runs it is compared with)."""
    import torch

    from dfac_tpu_torch.cli import train
    from dfac_tpu_torch.data.pipeline import load_dataset

    torch.backends.cudnn.deterministic = True
    args = train.parse_args(argv)
    train._fit(args, load_dataset(args.train_features, args.train_labels),
               load_dataset(args.dev_features, args.dev_labels))


def multihost_phase(dev, card: str) -> None:
    """Phase 22: multi-host training and sharded serving on the one card (see the module docstring)."""
    import pickle

    import pandas as pd
    import torch

    from dfac_tpu_torch import chain_rates
    from dfac_tpu_torch.data.normalizer import build_normalizer
    from dfac_tpu_torch.features.lfcc import LFCCConfig
    from dfac_tpu_torch.io.npy_store import save_npy_dataset
    from dfac_tpu_torch.models import build_model
    from dfac_tpu_torch.models.fast_infer import fold_cnn2d, predict_scores_fast
    from dfac_tpu_torch.ops import _build
    from dfac_tpu_torch.parallel import data_parallel as dpar
    from dfac_tpu_torch.parallel import serving
    from dfac_tpu_torch.train import rates
    from dfac_tpu_torch.train.checkpoint import load_model_variables, save_checkpoint
    from dfac_tpu_torch.train.evaluate import predict_scores
    from dfac_tpu_torch.utils.convert import jax_from_state_dict

    features = TRAIN_FEATURES
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t_phase = time.perf_counter()
    pool = dpar.RankPool([f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu"] * 2, backend="gloo",
                         timeout_s=MH_TIMEOUT_S)
    procs = {}
    with tempfile.TemporaryDirectory(prefix="dfac_smoke_mh_") as tmp:
        try:
            # -- inputs: a full-width CNN2D and CAE from a seed, a normalizer, the corpora (beside the pool's start)
            gen = torch.Generator().manual_seed(SEED)
            cnn = chain_rates.random_cnn2d(LFCCConfig(), "cpu", gen)
            torch.manual_seed(SEED)
            cae = chain_rates.seed_batchnorm(build_model("cae", base_channels=CAE_BASE).eval(), gen)
            sd = {k: v.numpy() for k, v in cnn.state_dict().items()}
            ds = rates.synthetic_dataset(MH_UTTS, features, N_FRAMES, 90)
            feats = torch.from_numpy(ds.features)  # the ranks get it through shared memory
            # the corpora as .npy stores (memory-mapped: each process pages in its rows), the detector's as pickles
            serve_ds = rates.synthetic_dataset(MH_CLI_UTTS, features, N_FRAMES, 91)
            fpath = os.path.join(tmp, "serve")
            save_npy_dataset(serve_ds, fpath)
            ck = {k: os.path.join(tmp, f"{k}.ckpt") for k in ("cnn2d", "cae")}
            save_checkpoint(ck["cnn2d"], jax_from_state_dict(cnn.state_dict(), "cnn2d"), config={"model": "cnn2d"})
            save_checkpoint(ck["cae"], jax_from_state_dict(cae.state_dict(), "cae"), config={"model": "cae"})
            norm_path = os.path.join(tmp, "normalizer.npz")
            build_normalizer(serve_ds.features, serve_ds.labels).save(norm_path)
            splits = {"train": rates.synthetic_dataset(TRAIN_UTTS, features, N_FRAMES, 92),
                      "dev": rates.synthetic_dataset(TRAIN_DEV_UTTS, features, N_FRAMES, 93)}
            for name, split in splits.items():
                save_npy_dataset(split, os.path.join(tmp, name))
            data = os.path.join(tmp, "data")
            for i, (name, n) in enumerate(MH_DETECTOR_UTTS.items()):
                write_split(data, name, alt_dataset(n, 94 + i))

            # -- the sharded scorers on two gloo ranks sharing the card, against the single-device chains
            got = pool.run(mh_rank_serving, dev.type, sd, feats, SEED, BATCH, timeout_s=MH_TIMEOUT_S)
            folded = {k: v.to(dev) for k, v in fold_cnn2d(cnn.state_dict()).items()}
            waves = mh_waves(dev, SEED, MH_UTTS, BATCH, N_FRAMES)
            single = serving.make_sharded_fast_scorer(LFCCConfig(), "gemm", compute_dtype=torch.bfloat16)
            cnn_sd = cnn.state_dict()
            singles = {
                "waves": lambda: torch.cat([single(folded, w) for w in waves]).cpu().numpy(),
                "feats": lambda: predict_scores_fast(cnn_sd, ds, dev, BATCH, compute_dtype=torch.float32),
            }
            n_b = MH_UTTS // BATCH
            for name, run in singles.items():
                want = run()
                secs = []
                for _ in range(MH_RATE_REPS):
                    t0 = time.perf_counter()
                    run()
                    secs.append(time.perf_counter() - t0)
                tol = 2.0**-8 if name == "waves" else 1e-6  # one bf16 last bit of a score in [0.5, 1); f32
                what = ("the waveform fast corpus scorer (K1 + K2, bf16)" if name == "waves" else
                        "predict --fast --data-parallel's f32 feature loop (K2) vs predict_scores_fast")
                for r, out in enumerate(got):
                    d = float(np.abs(out[name] - want).max())
                    launches = out[f"{name} launches"]
                    phase("multihost", f"rank {r} of 2 gloo ranks sharing {card}: {what}, {MH_UTTS} utterances at "
                                       f"global B={BATCH}: max abs {d:.3e} vs the single-device chain "
                                       f"({'bit for bit' if d == 0 else f'tolerance {tol:.3e}'}); launches "
                                       f"{launches} over {n_b} batches")
                    require(d <= tol, f"{name}: rank {r} against the single-device chain: {d}")
                    k1 = n_b if name == "waves" else 0
                    require(launches == {**dict.fromkeys(launches, 0), "gemm_frontend": k1, "conv_block": 3 * n_b},
                            f"{name} launches on rank {r}: {launches}")
                sharded = [MH_UTTS / s for s in got[0][f"{name} s"]]
                alone = [MH_UTTS / s for s in secs]
                phase("multihost", f"{what}: two gloo ranks sharing {card} {statistics.median(sharded):,.1f} utt/s "
                                   f"(min {min(sharded):,.1f}, max {max(sharded):,.1f}; rank 0's runs, each ending in "
                                   f"the gather) vs one process on {card} {statistics.median(alone):,.1f} utt/s (min "
                                   f"{min(alone):,.1f}, max {max(alone):,.1f}); median of {MH_RATE_REPS}. Two "
                                   "processes sharing one card: not a scale-out measurement")
            del waves, folded, singles, ds, feats, got
            torch.cuda.empty_cache()

            # -- the CLIs, all at once: serving (3 predict pairs, a hybrid pair and its single run, one NCCL
            # world-1 predict) and training (train host-fed and fused, train_cae, train_detector: a pair each)
            def cluster(n: int) -> list[list[str]]:
                port = dpar.free_port()
                return [["--multihost", "--coordinator-address", f"127.0.0.1:{port}", "--num-processes", str(n),
                         "--process-id", str(i)] for i in range(n)]

            def cli(module: str, *argv: str) -> list[str]:
                return [sys.executable, "-c", MH_CLI, module, *argv]

            out_of = lambda name: os.path.join(tmp, f"{name}.pkl")  # noqa: E731
            device = ["--device", dev.type]
            predict = ["--features", fpath, "--checkpoint", ck["cnn2d"], "--model", "cnn2d", "--fast",
                       "--in-features", str(features), "--batch-size", str(BATCH), *device]
            hybrid = ["--features", fpath, "--cnn-checkpoint", ck["cnn2d"], "--cae-checkpoint", ck["cae"],
                      "--normalizer", norm_path, "--batch-size", str(BATCH), "--fast", *device]
            serve_modes = {"f32": [], "bf16": ["--bf16"], "int8": ["--ingest-int8"]}
            commands = {}
            for mode, flags in serve_modes.items():
                for i, mh_flags in enumerate(cluster(2)):
                    commands[f"predict {mode} {i}"] = cli("dfac_tpu_torch.cli.predict", *predict, *flags, *mh_flags,
                                                          "--out", out_of(f"predict_{mode}_{i}"))
            for i, mh_flags in enumerate(cluster(2)):
                commands[f"hybrid {i}"] = cli("dfac_tpu_torch.cli.predict_hybrid", *hybrid, *mh_flags,
                                              "--out", out_of(f"hybrid_{i}"))
            commands["hybrid single"] = cli("dfac_tpu_torch.cli.predict_hybrid", *hybrid, "--out", out_of("hybrid"))
            commands["predict nccl"] = cli("dfac_tpu_torch.cli.predict", *predict, *cluster(1)[0],
                                           "--out", out_of("predict_nccl"))
            split_flags = [f"--{split}-{what}={os.path.join(tmp, split)}" for split in ("train", "dev")
                           for what in ("features", "labels")] + device
            train = [*split_flags, "--batch-size", str(TRAIN_BATCH), "--in-features", str(features), "--epochs", "2",
                     "--seed", str(SEED), "--label-smoothing", "0.05", "--lr-scheduler", "plateau", "--quiet"]
            ck_of = lambda name: os.path.join(tmp, "ck", name)  # noqa: E731
            for mode, flags in (("host-fed", []), ("fused", ["--fused-fit"])):
                for i, mh_flags in enumerate(cluster(2)):
                    commands[f"train {mode} {i}"] = cli("dfac_tpu_torch.cli.train", *train, *flags, *mh_flags,
                                                        "--checkpoint-dir", ck_of(f"train_{mode}_{i}"))
            for i, mh_flags in enumerate(cluster(2)):
                commands[f"train_cae {i}"] = cli("dfac_tpu_torch.cli.train_cae", *split_flags, "--epochs", "1",
                                                 "--batch-size", str(TRAIN_BATCH), "--quiet", *mh_flags,
                                                 "--checkpoint-dir", ck_of(f"cae_{i}"))
            for i, mh_flags in enumerate(cluster(2)):
                commands[f"train_detector {i}"] = cli(
                    "dfac_tpu_torch.cli.train_detector", "--data-dir", data, *device, "--epochs", "1", "--batch-size",
                    str(TRAIN_BATCH), "--hidden", str(DETECTOR_HIDDEN), "--ema", *mh_flags,
                    "--ckpt-path", ck_of(f"det_{i}/det.ckpt"), "--prediction-pkl", out_of(f"det_{i}"))
            os.makedirs(ck_of("det_0"))
            os.makedirs(ck_of("det_1"))
            t_cli = time.perf_counter()
            procs = start_all(commands, env)
            # beside them, the two-rank DP fit the multi-host fits are held to
            dp_dir = ck_of("train_dp")
            pool.run(mh_rank_fit, [*train, "--data-parallel", "2", "--checkpoint-dir", dp_dir], timeout_s=MH_TIMEOUT_S)
            t_dp = time.perf_counter() - t_cli
            outs = finish_all(procs)
            procs = {}
            phase("multihost", f"{len(commands)} CLIs (concurrent, on {card}, beside the two-rank DP fit of "
                               f"{t_dp:.1f}s): {time.perf_counter() - t_cli:.1f}s")
            for label, out in outs.items():
                for line in out.strip().splitlines():
                    phase("multihost", f"cli {label}: {line}")
            launches = {k: json.loads(re.search(r"^launches (.*)$", v, re.M).group(1)) for k, v in outs.items()}

            # -- serving: each pair's file against predict --fast on one device; process 1 writes nothing
            n_cli = -(-MH_CLI_UTTS // BATCH)
            for mode, flags in serve_modes.items():
                got_df = pd.read_pickle(out_of(f"predict_{mode}_0"))
                want = predict_scores_fast(cnn_sd, serve_ds, dev, BATCH, compute_dtype=torch.bfloat16
                                           if mode == "bf16" else torch.float32, ingest_int8=mode == "int8")
                d = float(np.abs(got_df["predictions"].to_numpy() - want).max())
                tol = 2.0**-8 if mode == "bf16" else 1e-6
                per = [launches[f"predict {mode} {i}"] for i in range(2)]
                phase("multihost", f"predict --fast{''.join(' ' + f for f in flags)} --multihost --num-processes 2 "
                                   f"on {card}, {MH_CLI_UTTS} utterances: process 0's file vs predict --fast on one "
                                   f"device, max abs {d:.3e} ({'bit for bit' if d == 0 else f'tolerance {tol:.3e}'});"
                                   f" launches per process {per} over {n_cli} batches")
                require(got_df["uttid"].tolist() == serve_ds.uttids and d <= tol, f"predict {mode}: {d}")
                require(not os.path.exists(out_of(f"predict_{mode}_1")), f"predict {mode}: process 1 wrote")
                for p in per:
                    require(p == {**dict.fromkeys(p, 0), "conv_block": 3 * n_cli}, f"predict {mode} launches: {per}")
            nccl = pd.read_pickle(out_of("predict_nccl"))["predictions"].to_numpy()
            want = predict_scores_fast(cnn_sd, serve_ds, dev, BATCH, compute_dtype=torch.float32)
            d = float(np.abs(nccl - want).max())
            require("over nccl" in outs["predict nccl"] and d <= 1e-6, f"predict nccl: {d}")
            phase("multihost", f"predict --fast --multihost --num-processes 1 (world 1, NCCL): max abs {d:.3e} vs "
                               "predict --fast on one device")
            hybrid_got, hybrid_want = (pd.read_pickle(out_of(n))["predictions"].to_numpy() for n in ("hybrid_0", "hybrid"))
            d = float(np.abs(hybrid_got - hybrid_want).max())
            per = [launches[f"hybrid {i}"] for i in range(2)]
            phase("multihost", f"predict_hybrid --fast --multihost --num-processes 2: max abs {d:.3e} vs "
                               f"predict_hybrid --fast in one process; CNN2D-leg launches per process {per}")
            require(d <= 2.0**-8 and not os.path.exists(out_of("hybrid_1")), f"hybrid: {d}")
            for p in per:
                require(p == {**dict.fromkeys(p, 0), "conv_block": 3 * n_cli}, f"hybrid launches: {per}")

            # -- training: each multi-host pair against the two-rank DP fit; one writer a pair
            def ckpt(path):
                with open(path, "rb") as f:
                    return pickle.load(f)

            def leaves(tree):
                if isinstance(tree, dict):
                    return [x for k in sorted(tree) for x in leaves(tree[k])]
                return [np.asarray(tree, np.float64)]

            for mode in ("host-fed", "fused"):
                run_dir = ck_of(f"train_{mode}_0")
                require(not os.path.exists(ck_of(f"train_{mode}_1")), f"train {mode}: process 1 wrote")
                rel, same = 0.0, True
                for name in ("cnn2d_best.ckpt", "cnn2d_last.ckpt"):
                    a, b = ckpt(os.path.join(run_dir, name)), ckpt(os.path.join(dp_dir, name))
                    same &= a["epoch"] == b["epoch"]
                    pairs = list(zip(leaves(a["model_state"]), leaves(b["model_state"])))
                    if name == "cnn2d_last.ckpt":  # a fused run's best file holds the run's final state (JAX's CLI)
                        ta, tb = a["config"]["_trainer_state"], b["config"]["_trainer_state"]
                        same &= ta.keys() == tb.keys() and all((ta[k] is None) == (tb[k] is None) for k in ta)
                        pairs += [(ta[k], tb[k]) for k in ta if ta[k] is not None]
                    for x, y in pairs:
                        rel = max(rel, float(np.max(np.abs(np.asarray(x, np.float64) - y)
                                                    / np.maximum(np.abs(y), 1e-6))))
                best = ckpt(os.path.join(run_dir, "cnn2d_best.ckpt"))
                phase("multihost", f"train --multihost --num-processes 2 {mode}, CNN2D full width, B={TRAIN_BATCH}, "
                                   f"2 epochs on {TRAIN_UTTS} / {TRAIN_DEV_UTTS} utterances (.npy stores), cuDNN "
                                   f"deterministic: vs the two-rank DP fit, the same best epoch "
                                   f"({best['epoch']}) and trainer state: {same}; weights and best-tracking state max "
                                   f"rel {rel:.3e} (tolerance {REST_RTOL})")
                require(same and rel <= REST_RTOL, f"train {mode} vs the DP fit: same {same}, rel {rel}")
            for name, files in (("train_cae", ("cae_best.ckpt", "cae_last.ckpt", "normalizer.npz")),
                                ("train_detector", ("det.ckpt",))):
                d0, d1 = (ck_of(f"{'cae' if name == 'train_cae' else 'det'}_{i}") for i in range(2))
                require(all(os.path.exists(os.path.join(d0, f)) for f in files), f"{name}: process 0 wrote no files")
                require(not (os.path.exists(d1) and os.listdir(d1)), f"{name}: process 1 wrote into {d1}")
            require(os.path.exists(out_of("det_0")) and not os.path.exists(out_of("det_1")),
                    "train_detector: process 0 alone scores test2")
            phase("multihost", "train_cae and train_detector --multihost --num-processes 2, 1 epoch: exit 0, "
                               "process 0 alone wrote its files (process 1's directories empty)")

            # -- the multi-host-trained checkpoint served as predict --fast (K2 f32) and predict serve it
            model = build_model("cnn2d", in_features=features)
            model.load_state_dict(load_model_variables(os.path.join(ck_of("train_host-fed_0"), "cnn2d_best.ckpt")))
            dev_ds = splits["dev"]
            _build.reset_launch_counts()
            fast = predict_scores_fast(model.state_dict(), dev_ds, dev, batch_size=BATCH,
                                       compute_dtype=torch.float32)
            served = _build.launch_counts()
            n_served = -(-len(dev_ds) // BATCH)
            plain = predict_scores(model.to(dev), dev_ds, batch_size=BATCH, apply_sigmoid=True)
            d = float(np.abs(fast - plain).max())
            phase("multihost", f"the multi-host-trained CNN2D's best checkpoint: predict_scores_fast (K2 f32) vs "
                               f"predict_scores on {len(dev_ds)} utterances: max abs {d:.3e} (tolerance "
                               f"{F32_SCORE_ATOL}), launches over {n_served} batches {served}")
            require(served == {**dict.fromkeys(served, 0), "conv_block": 3 * n_served}, f"served: {served}")
            require(d <= F32_SCORE_ATOL, "predict and predict --fast disagree on the multi-host-trained checkpoint")
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.communicate()
            pool.close()
    phase("multihost", f"phase 22: {time.perf_counter() - t_phase:.1f}s")


def kernel_phases():
    """Phases 1-14; returns ``(kernels, kind, card, dev)``, or None without a GPU."""
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return None
    sys.path.insert(0, ROOT)
    from dfac_tpu_torch.data.pipeline import ArrayDataset
    from dfac_tpu_torch.features.lfcc import METHODS, LFCCConfig, batch_features, lfcc_features, \
        lfcc_features_batch, linear_filterbank, power_spectrum
    from dfac_tpu_torch.io.npy_store import load_npy_dataset
    from dfac_tpu_torch.io.pickle_io import load_features
    from dfac_tpu_torch import chain_rates
    from dfac_tpu_torch.models.fast_infer import fold_cnn2d, predict_scores_fast
    from dfac_tpu_torch.ops import _build, conv_probe
    from dfac_tpu_torch.ops.conv_block import cnn2d_fused_scores, cnn2d_head, fused_conv_block, reference_conv_block
    from dfac_tpu_torch.ops.gemm_frontend import append_deltas, cepstra_plain, frames_by_reshape, gemm_lfcc_cepstra, \
        gemm_lfcc_features_tf, host_constants
    from dfac_tpu_torch.ops.lfcc_kernel import fb_log_dct_plain, fused_fb_log_dct
    from dfac_tpu_torch.ops.pool import time_pool, time_pool_plain
    from dfac_tpu_torch.scripts import train_opt_probe

    # -- 1. device --------------------------------------------------------
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True, capture_output=True, text=True).stdout
    phase("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc {nvcc.strip().splitlines()[-1]}")
    phase("device", f"card: {card}; devices: {torch.cuda.device_count()}")
    # the plain versions are the f32 reference: no TF32 in matmul or cuDNN conv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    lib = _build.library()
    phase("build", f"{os.path.relpath(lib_path, ROOT)} in {time.perf_counter() - t0:.1f}s")
    smem = {
        "frontend_bf16": lib.dfac_gemm_frontend_smem(1),
        "frontend_f32": lib.dfac_gemm_frontend_smem(0),
        "conv_block_cin1_tc 1->32": lib.dfac_conv_block_smem(1, 32, 1),
        "conv_block_cin1_f32 1->32": lib.dfac_conv_block_smem(1, 32, 0),
        "conv_block_tc 32->64": lib.dfac_conv_block_smem(32, 64, 1),
        "conv_block_tc 64->128": lib.dfac_conv_block_smem(64, 128, 1),
        "conv_block_f32 32->64": lib.dfac_conv_block_smem(32, 64, 0),
        "conv_block_f32 64->128": lib.dfac_conv_block_smem(64, 128, 0),
        "fb_log_dct_kernel": lib.dfac_fb_log_dct_smem(),
        "conv1_tc g": lib.dfac_conv_probe_smem(0, 256, 256, 32),
        "conv1_tc h": lib.dfac_conv_probe_smem(1, 256, 128, 32),
        "conv1_tc i": lib.dfac_conv_probe_smem(2, 256, 256, 32),
        "conv2_checksum": lib.dfac_conv_probe_smem(3, 192, 176, 64),
        "conv1_checksum v1": lib.dfac_conv_pass_smem(1, 180, 32),
        "conv1_checksum d": lib.dfac_conv_pass_smem(7, 180, 32),
        "conv1_tc v2, v3": lib.dfac_conv_pass_smem(2, 180, 32),
        "conv1_tc a": lib.dfac_conv_pass_smem(5, 180, 32),
        "conv1_tc c": lib.dfac_conv_pass_smem(6, 182, 32),
        "conv1_emit v4": lib.dfac_conv_pass_smem(4, 180, 32),
        "conv1_tc h2": lib.dfac_conv_chunk_smem(0, 256, 256, 32),
        "conv1_tc i2": lib.dfac_conv_chunk_smem(1, 256, 256, 32),
        "conv2_checksum j4": lib.dfac_conv_chunk_smem(2, 192, 176, 64),
        "conv2_checksum j5": lib.dfac_conv_chunk_smem(3, 192, 176, 128),
        "conv1_tc c2": lib.dfac_conv_chunk_smem(4, 182, 65536, 32),
        "conv_block_w8a8 32->64": lib.dfac_conv_block_w8a8_smem(32, 64),
        "conv_block_w8a8 64->128": lib.dfac_conv_block_w8a8_smem(64, 128),
    }
    phase("build", "dynamic shared memory per block: " + ", ".join(f"{k} {v:,} B" for k, v in smem.items()))
    name, spills = None, "0"
    for line in _build.ptxas_report().splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:  # a kernel of ours, with its template arguments (mangled), or None
            k = re.search(r"(?<=\d)(frontend_bf16|frontend_f32|conv_block_tc|conv_block_f32|conv_block_direct|"
                          r"conv_block_cin1_tc|conv_block_cin1_f32|conv_block_cin1|fb_log_dct_kernel|"
                          r"time_pool_kernel|conv1_checksum|conv2_checksum|sum_sq_checksum|conv1_tc|conv1_emit|"
                          r"conv_block_w8a8|block1_w8a8_tc|block1_w8a8_f32)"
                          r"(?:I(\w*?)EEv)?", m.group(1))
            name, spills = k and k.group(1) + (f"<{k.group(2)}>" if k.group(2) else ""), "0"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:  # spills shown where there are any, and always for the probe kernels and K4
            shown = (f", {spills} bytes spill stores"
                     if spills != "0" or name.startswith(("conv2_checksum", "conv1_tc", "conv1_checksum",
                                                          "conv1_emit", "fb_log_dct_kernel", "conv_block_w8a8",
                                                          "block1_w8a8"))
                     else "")
            phase("build", f"ptxas {name}: {m.group(1)} registers{shown}")
    check_units(lib_path)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = LFCCConfig()
    n_samples = cfg.num_samples(N_FRAMES)

    # -- 3. K1 vs plain ---------------------------------------------------
    wave = torch.randn(BATCH, n_samples, device=dev, generator=gen)
    k1_err = {}
    for dt in (torch.bfloat16, torch.float32):
        got = gemm_lfcc_cepstra(wave, cfg, dt)
        want = cepstra_plain(wave, cfg, dt)
        torch.cuda.synchronize()
        require(got.shape == want.shape == (BATCH, N_FRAMES, cfg.n_ceps), got.shape)
        require(torch.isfinite(got).all(), "K1 output is not finite")
        abs_err, rel_err = max_errors(got, want)
        ok = bool(((got - want).abs() <= K1_ATOL + K1_RTOL * want.abs()).all())
        phase("K1", f"{str(dt)[6:]} {tuple(got.shape)}: max abs {abs_err:.3e}, max rel {rel_err:.3e} "
                    f"(tolerance atol {K1_ATOL} + rtol {K1_RTOL})")
        if not ok:
            raise AssertionError(f"K1 {dt} disagrees with its plain version")
        if not torch.equal(gemm_lfcc_cepstra(wave, cfg, dt), got):
            raise AssertionError(f"K1 {dt}: a second call gives other cepstra")
        phase("K1", f"{str(dt)[6:]}: a second call equals the first bit for bit")
        k1_err[dt] = abs_err

    # -- 4. K4 vs plain ---------------------------------------------------
    power = power_spectrum(wave, cfg)
    phase("K4", f"walk: {lib.dfac_fb_log_dct_tile_rows()}-row tiles, {lib.dfac_fb_log_dct_stages()} ring slots, "
                f"{lib.dfac_fb_log_dct_grid(BATCH * N_FRAMES)} blocks at B={BATCH}, "
                f"{lib.dfac_fb_log_dct_grid(EXTRACT_BATCH * N_FRAMES)} at B={EXTRACT_BATCH}")
    k4_err = 0.0
    for b in (BATCH, EXTRACT_BATCH):
        got = fused_fb_log_dct(power[:b], cfg)
        want = fb_log_dct_plain(power[:b], cfg)
        torch.cuda.synchronize()
        require(got.shape == want.shape == (b, N_FRAMES, cfg.n_ceps), got.shape)
        require(torch.isfinite(got).all(), "K4 output is not finite")
        abs_err, rel_err = max_errors(got, want)
        phase("K4", f"f32 power {tuple(power[:b].shape)} ({b * N_FRAMES} rows) -> {tuple(got.shape)}: max abs "
                    f"{abs_err:.3e}, max rel {rel_err:.3e} (tolerance atol {K4_ATOL} + rtol {K4_RTOL})")
        if not bool(((got - want).abs() <= K4_ATOL + K4_RTOL * want.abs()).all()):
            raise AssertionError(f"K4 disagrees with its plain version at B={b}")
        if not torch.equal(fused_fb_log_dct(power[:b], cfg), got):
            raise AssertionError(f"K4 B={b}: a second call gives other cepstra")
        k4_err = max(k4_err, abs_err)
    phase("K4", "a second call equals the first bit for bit at both batches")
    got = lfcc_features(wave, cfg, use_kernel=True)
    want = lfcc_features(wave, cfg)
    torch.cuda.synchronize()
    require(got.shape == want.shape == (BATCH, cfg.feature_dim, N_FRAMES), got.shape)
    abs_err, rel_err = max_errors(got, want)
    phase("K4", f"lfcc_features(use_kernel=True) {tuple(got.shape)} vs plain: max abs {abs_err:.3e}, "
                f"max rel {rel_err:.3e} (tolerance atol {K4_ATOL} + rtol {K4_RTOL})")
    if not bool(((got - want).abs() <= K4_ATOL + K4_RTOL * want.abs()).all()):
        raise AssertionError("the rFFT front-end through K4 disagrees with the plain one")

    # -- 5. K2 vs plain ---------------------------------------------------
    shapes = [((BATCH, 321, 180, 1), 32, True), ((BATCH, 160, 180, 32), 64, True), ((BATCH, 80, 180, 64), 128, False)]
    k2_inputs, k2_err = [], 0.0
    for xs, c_out, pool in shapes:
        x = torch.randn(*xs, device=dev, generator=gen).to(torch.bfloat16)
        w = torch.randn(3, 3, xs[-1], c_out, device=dev, generator=gen) * (2.0 / (9 * xs[-1])) ** 0.5
        b = torch.randn(c_out, device=dev, generator=gen) * 0.1
        got = fused_conv_block(x, w, b, pool)
        want = reference_conv_block(x, w, b, pool)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == torch.bfloat16, (got.shape, want.shape))
        gf, wf = got.float(), want.float()
        ok = bool(((gf - wf).abs() <= K2_ATOL + K2_RTOL * torch.maximum(gf.abs(), wf.abs())).all())
        abs_err, rel_err = max_errors(got, want)
        phase("K2", f"bf16 x{xs} -> {tuple(got.shape)} pool={pool}: max abs {abs_err:.3e}, max rel {rel_err:.3e} "
                    f"(tolerance one bf16 last bit: rtol 2^-7 + atol {K2_ATOL})")
        if not ok:
            raise AssertionError(f"K2 {xs} disagrees with its plain version")
        if not torch.equal(fused_conv_block(x, w, b, pool), got):
            raise AssertionError(f"K2 {xs}: a second call gives another result")
        k2_err = max(k2_err, abs_err)
        k2_inputs.append((x, w, b, pool))
    phase("K2", "bf16: a second call of each block equals the first bit for bit")
    k2_f32_inputs, k2_f32_err = [(x.float(), w, b, pool) for x, w, b, pool in k2_inputs], 0.0
    for x, w, b, pool in k2_f32_inputs:
        got = fused_conv_block(x, w, b, pool)
        want = reference_conv_block(x, w, b, pool)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == torch.float32, (got.shape, want.shape))
        abs_err, rel_err = max_errors(got, want)
        phase("K2", f"f32 x{tuple(x.shape)} -> {tuple(got.shape)} pool={pool}: max abs {abs_err:.3e}, max rel "
                    f"{rel_err:.3e} (tolerance atol {K2_F32_TOL} + rtol {K2_F32_TOL})")
        if not bool(((got - want).abs() <= K2_F32_TOL + K2_F32_TOL * want.abs()).all()):
            raise AssertionError(f"K2 f32 {tuple(x.shape)} disagrees with its plain version")
        k2_f32_err = max(k2_f32_err, abs_err)
    del got, want

    # -- 6. end-to-end slice ----------------------------------------------
    model = chain_rates.random_cnn2d(cfg, dev, gen)  # non-trivial BN statistics, so the folding is exercised
    folded = fold_cnn2d(model.state_dict())
    n_batches = 2
    waves = torch.randn(n_batches, BATCH, n_samples, device=dev, generator=gen)

    _build.reset_launch_counts()
    with torch.inference_mode():
        scores = [cnn2d_fused_scores(folded, gemm_lfcc_features_tf(wv, cfg, torch.bfloat16)) for wv in waves]
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    phase("slice", f"launches over {n_batches} batches: {launches}")
    if launches != {**dict.fromkeys(launches, 0), "gemm_frontend": n_batches, "conv_block": 3 * n_batches}:
        raise AssertionError(f"the slice did not run through the kernels as expected: {launches}")

    with torch.inference_mode():
        for wv, got in zip(waves, scores):
            feats_plain = append_deltas(cepstra_plain(wv, cfg, torch.bfloat16), cfg)
            h = feats_plain.to(torch.bfloat16)[..., None]
            for i, pool in ((1, True), (2, True), (3, False)):
                h = reference_conv_block(h, folded[f"w{i}"], folded[f"b{i}"], pool)
            plain = cnn2d_head(h, folded)
            f32_model = torch.sigmoid(model(feats_plain)[:, 0])
            require(got.shape == (BATCH,) and torch.isfinite(got).all(), "slice scores")
            d_plain = (got - plain).abs().max().item()
            d_model = (got - f32_model).abs().max().item()
            phase("slice", f"scores {tuple(got.shape)} in [{got.min().item():.4f}, {got.max().item():.4f}]: "
                           f"max |kernels - all-plain| {d_plain:.3e}, max |kernels - f32 model| {d_model:.3e} "
                           f"(tolerance {SCORE_ATOL})")
            if d_plain > SCORE_ATOL or d_model > SCORE_ATOL:
                raise AssertionError("slice scores disagree with the plain chain")

    # -- 7. CLI -----------------------------------------------------------
    import pandas as pd

    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory(prefix="dfac_smoke_") as tmp:
        labels = (np.arange(CLI_UTTS) % 2).astype(np.int64)
        feats = rng.normal(size=(CLI_UTTS, cfg.feature_dim, N_FRAMES)).astype(np.float32)
        feats[labels == 1, :60, :] += 1.5  # separable on the LFCC block
        uttids = [f"utt{i:05d}" for i in range(CLI_UTTS)]
        fpath, lpath = os.path.join(tmp, "features.pkl"), os.path.join(tmp, "labels.pkl")
        ckpt, pred = os.path.join(tmp, "cnn2d_best.pt"), os.path.join(tmp, "prediction.pkl")
        pd.DataFrame({"uttid": uttids, "features": [torch.from_numpy(m) for m in feats]}).to_pickle(fpath)
        pd.DataFrame({"uttid": uttids, "label": labels}).to_pickle(lpath)
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        out = subprocess.run(
            [sys.executable, "-m", "dfac_tpu_torch.cli.predict", "--features", fpath, "--checkpoint", ckpt,
             "--model", "cnn2d", "--out", pred, "--fast", "--bf16", "--device", "cuda"],
            check=True, capture_output=True, text=True, cwd=ROOT, env=env,
        ).stdout
        for line in out.strip().splitlines():
            phase("cli", f"predict: {line}")
        df = pd.read_pickle(pred)
        require(list(df.columns) == ["uttid", "predictions"] and len(df) == CLI_UTTS, df.shape)
        require(np.isfinite(df["predictions"].to_numpy()).all(), "predictions are not finite")
        out = subprocess.run(
            [sys.executable, "-m", "dfac_tpu_torch.cli.evaluate", pred, lpath],
            check=True, capture_output=True, text=True, cwd=ROOT, env=env,
        ).stdout
        eer = float(re.search(r"EER: (\S+)", out).group(1))
        phase("cli", f"evaluate: {' | '.join(out.strip().splitlines())}")
        if not np.isfinite(eer):
            raise AssertionError(f"EER is not finite: {eer}")

    # predict --fast's default f32 chain (no --bf16), in process for the launch counts
    ds = ArrayDataset(uttids=uttids, features=feats)
    _build.reset_launch_counts()
    f32_scores = predict_scores_fast(model.state_dict(), ds, dev, batch_size=BATCH, compute_dtype=torch.float32)
    f32_launches = _build.launch_counts()
    n_f32 = -(-CLI_UTTS // BATCH)
    phase("cli", f"predict_scores_fast f32: launches over {n_f32} batches: {f32_launches}")
    if f32_launches != {**dict.fromkeys(f32_launches, 0), "conv_block": 3 * n_f32}:
        raise AssertionError(f"the f32 chain did not run through the kernels as expected: {f32_launches}")
    with torch.inference_mode():
        feats_tf = torch.from_numpy(feats).to(dev).transpose(1, 2)
        f32_model = torch.cat([torch.sigmoid(model(feats_tf[s : s + BATCH].contiguous())[:, 0])
                               for s in range(0, CLI_UTTS, BATCH)]).cpu().numpy()
    d = np.abs(f32_scores - f32_model).max()
    phase("cli", f"predict_scores_fast f32 {f32_scores.shape}: max |kernels - f32 model| {d:.3e} "
                 f"(tolerance {F32_SCORE_ATOL})")
    if not (f32_scores.shape == (CLI_UTTS,) and d <= F32_SCORE_ATOL):
        raise AssertionError("the f32 chain's scores disagree with the f32 model")

    # -- 8. extraction, in process ----------------------------------------
    ext_waves = (0.1 * np.random.default_rng(SEED + 1).normal(size=(EXTRACT_UTTS, n_samples))).astype(np.float32)
    n_ext = -(-EXTRACT_UTTS // EXTRACT_BATCH)
    expect = {"gemm": "gemm_frontend", "fft-pallas": "fb_log_dct", "fft": None}
    ext, ext_launches = {}, {}
    for method in METHODS:
        _build.reset_launch_counts()
        ext[method] = lfcc_features_batch(ext_waves, cfg, EXTRACT_BATCH, method, dev)
        ext_launches[method] = _build.launch_counts()
        phase("extract", f"{method}: {ext[method].shape} {ext[method].dtype}, launches over {n_ext} batches: "
                         f"{ext_launches[method]}")
        require(ext[method].shape == (EXTRACT_UTTS, cfg.feature_dim, N_FRAMES), ext[method].shape)
        require(ext[method].dtype == np.float32 and np.isfinite(ext[method]).all(), f"{method} features")
        want = {k: (n_ext if k == expect[method] else 0) for k in ext_launches[method]}
        if ext_launches[method] != want:
            raise AssertionError(f"{method} did not run through the kernels as expected: {ext_launches[method]}")
    for a, b, atol, rtol in (("fft", "gemm", METHOD_ATOL, METHOD_RTOL), ("fft-pallas", "fft", K4_ATOL, K4_RTOL)):
        d = np.abs(ext[a] - ext[b])
        ok = bool((d <= atol + rtol * np.abs(ext[b])).all())
        phase("extract", f"{a} vs {b}: max abs {d.max():.3e} (tolerance atol {atol} + rtol {rtol})")
        if not ok:
            raise AssertionError(f"extraction methods {a} and {b} disagree")

    # -- 9. extraction CLI, then predict on its store ----------------------
    rng = np.random.default_rng(SEED + 2)
    with tempfile.TemporaryDirectory(prefix="dfac_smoke_") as tmp:
        lengths = rng.integers(n_samples // 2, n_samples * 3 // 2, size=CLI_UTTS)  # crop and pad
        archive = {f"utt{i:05d}": (0.1 * rng.normal(size=n)).astype(np.float32) for i, n in enumerate(lengths)}
        npz = os.path.join(tmp, "audio.npz")
        np.savez(npz, **archive)
        uttids = sorted(archive)
        padded = np.zeros((CLI_UTTS, n_samples), np.float32)
        for i, u in enumerate(uttids):
            n = min(len(archive[u]), n_samples)
            padded[i, :n] = archive[u][:n]
        fpath, store = os.path.join(tmp, "features.pkl"), os.path.join(tmp, "store")
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        for fmt, out_path in (("pkl", fpath), ("npy", store)):
            out = subprocess.run(
                [sys.executable, "-m", "dfac_tpu_torch.cli.extract_features", "--audio", npz, "--out", out_path,
                 "--format", fmt, "--device", "cuda"],
                check=True, capture_output=True, text=True, cwd=ROOT, env=env,
            ).stdout
            for line in out.strip().splitlines():
                phase("extract-cli", f"--format {fmt}: {line}")
        pkl_uttids, pkl_feats = load_features(fpath)
        ds = load_npy_dataset(store)
        require(pkl_uttids == ds.uttids == uttids, "uttids are not the sorted archive keys")
        require(pkl_feats.shape == ds.features.shape == (CLI_UTTS, cfg.feature_dim, N_FRAMES), pkl_feats.shape)
        if not np.array_equal(pkl_feats, np.asarray(ds.features)):
            raise AssertionError("features.pkl and the .npy store hold different features")
        in_process = lfcc_features_batch(padded, cfg, EXTRACT_BATCH, "gemm", dev)
        if not np.array_equal(pkl_feats, in_process):
            raise AssertionError("the CLI's features differ from the driver's on the same padded waveforms")
        phase("extract-cli", f"features.pkl and store: identical {pkl_feats.shape} f32, sorted uttids, "
                             f"equal to the in-process driver on the padded waveforms")

        ckpt, pred = os.path.join(tmp, "cnn2d_best.pt"), os.path.join(tmp, "prediction.pkl")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
        out = subprocess.run(
            [sys.executable, "-m", "dfac_tpu_torch.cli.predict", "--features", store, "--checkpoint", ckpt,
             "--model", "cnn2d", "--out", pred, "--fast", "--bf16", "--device", "cuda"],
            check=True, capture_output=True, text=True, cwd=ROOT, env=env,
        ).stdout
        for line in out.strip().splitlines():
            phase("extract-cli", f"predict on the store: {line}")
        df = pd.read_pickle(pred)
        require(df["uttid"].tolist() == uttids, "prediction uttids")
        with torch.inference_mode():
            wv = torch.from_numpy(padded).to(dev)
            slice_scores = torch.cat([
                cnn2d_fused_scores(folded, gemm_lfcc_features_tf(wv[s : s + BATCH], cfg, torch.bfloat16))
                for s in range(0, CLI_UTTS, BATCH)
            ]).float().cpu().numpy()
        d = np.abs(df["predictions"].to_numpy() - slice_scores).max()
        phase("extract-cli", f"predict on the store vs the slice on the same waveforms: max abs {d:.3e} "
                             f"(tolerance {SCORE_ATOL})")
        if not d <= SCORE_ATOL:
            raise AssertionError("predict on the extracted store disagrees with the slice")

    # -- 10. K5 vs plain --------------------------------------------------
    k5_inputs = [torch.randn(*shape, device=dev, generator=gen).to(torch.bfloat16) for shape in POOL_SHAPES]
    k5_err = 0.0
    for x in k5_inputs:
        before = _build.launch_counts()["time_pool"]
        got = time_pool(x)
        want = time_pool_plain(x)
        torch.cuda.synchronize()
        require(_build.launch_counts()["time_pool"] == before + 1, "K5: one launch per call")
        require(got.shape == want.shape == (x.shape[0], x.shape[1] // 2, *x.shape[2:]), got.shape)
        k5_err = max(k5_err, max_errors(got, want)[0])
        if not torch.equal(got, want):
            raise AssertionError(f"K5 {tuple(x.shape)} differs from its plain version")
        lib_equal = torch.equal(F.avg_pool2d(x.permute(0, 3, 1, 2), (2, 1)).permute(0, 2, 3, 1), got)
        phase("K5", f"bf16 {tuple(x.shape)} -> {tuple(got.shape)}: bit-identical to the plain version "
                    f"(max abs {k5_err:.3e}; tolerance: none); F.avg_pool2d {'identical' if lib_equal else 'differs'}")
    for shape, dt in (((8, 33, 180, 32), torch.float32), ((8, 65, 7, 3), torch.bfloat16)):
        x = torch.randn(*shape, device=dev, generator=gen).to(dt)
        got, want = time_pool(x), time_pool_plain(x)
        torch.cuda.synchronize()
        k5_err = max(k5_err, max_errors(got, want)[0])
        if not torch.equal(got, want):
            raise AssertionError(f"K5 {shape} {dt} differs from its plain version")
        phase("K5", f"{str(dt)[6:]} {shape} -> {tuple(got.shape)} (odd T, rows of {shape[2] * shape[3]} "
                    f"elements): bit-identical")

    # -- 11. conv-probe checksums vs plain ----------------------------------
    y_of = {  # the conv kernels' cases (conv1_checksum, conv1_tc, conv2_checksum), each returning its sums and every y
        "v1": lambda a, w: conv_probe.conv1_same_checksum(a, w, "fma", return_y=True),
        "d": lambda a, w: conv_probe.conv1_valid_checksum(a, w, "fma", return_y=True),
        "g": lambda a, w: conv_probe.conv1_taps_checksum(a, w, "roll", return_y=True),
        "h": lambda a, w: conv_probe.conv1_taps_checksum(a, w, "slice", return_y=True),
        "i": lambda a, w: conv_probe.patches_checksum(a, w, return_y=True),
        "v2": lambda a, w: conv_probe.conv1_same_checksum(a, w, "mma", return_y=True),
        "v3": lambda a, w: conv_probe.conv1_group_checksum(a, w, return_y=True),
        "a": lambda a, w: conv_probe.conv1_valid_checksum(a, w, "mma", return_y=True),
        "c": lambda a, w: conv_probe.flat_shift_checksum(a, w, return_y=True),
        "h2": lambda a, w: conv_probe.chunked_taps_checksum(a, w, return_y=True),
        "i2": lambda a, w: conv_probe.tap_planes_checksum(a, w, return_y=True),
        "c2": lambda a, w: conv_probe.flat_chunks_checksum(a, w, return_y=True),
        "j": lambda a, w: conv_probe.conv2_checksum(a, w, "slice", return_y=True),
        "k": lambda a, w: conv_probe.conv2_checksum(a, w, "roll", return_y=True),
        "f": lambda a, w: conv_probe.conv2_dx_checksum(a, w, return_y=True),
        "j2": lambda a, w: conv_probe.conv2_checksum(a, w, "slice", return_y=True, key="conv_chunked"),
        "j3": lambda a, w: conv_probe.conv2_checksum(a, w, "slice", return_y=True, key="conv_trailing"),
        "j4": lambda a, w: conv_probe.conv2_dx_window_checksum(a, w, return_y=True),
        "j5": lambda a, w: conv_probe.conv3_checksum(a, w, return_y=True),
    }

    def check_y(label, name, a, wt, sums, want_y):
        """A conv case's every output against the plain version's, and
        its sums with y equal to its sums alone, bit for bit."""
        got_sums, got_y = y_of[name](a, wt)
        torch.cuda.synchronize()
        require(torch.equal(got_sums, sums), f"{name}: the sums with y differ from the sums alone")
        require(got_y.shape == want_y.shape, (got_y.shape, want_y.shape))
        d = (got_y - want_y).abs_()
        ok = bool((d <= Y_ATOL + Y_RTOL * want_y.abs()).all())
        phase(label, f"{name} y {tuple(got_y.shape)}: max |kernel - plain| {d.max().item():.3e} (tolerance atol "
                     f"{Y_ATOL} + rtol {Y_RTOL})")
        del got_y, d
        if not ok:
            raise AssertionError(f"case {name}: y disagrees with its plain version")

    probe_arrs = train_opt_probe.stage13_inputs(PROBE_BATCH, torch.bfloat16, dev, SEED)
    cp_err = 0.0
    for name, case in conv_probe.CASES.items():
        a, wt = probe_arrs[case.inp], probe_arrs[case.weights]
        before = _build.launch_counts()["conv_probe"]
        got = case.kernel(a, wt)
        torch.cuda.synchronize()
        require(_build.launch_counts()["conv_probe"] == before + 1, "conv-probe: one launch per call")
        y = case.plain(a, wt)
        want = conv_probe.checksum(y)
        abs_sum = y.abs().sum(dim=(1, 2, 3), dtype=torch.float64)
        y_shape = tuple(y.shape)
        if name in y_of:
            check_y("conv-probe", name, a, wt, got, y)
        del y
        require(got.shape == want.shape == (PROBE_BATCH, 8, 128) and torch.isfinite(got).all(), got.shape)
        require(torch.equal(got, got[:, :1, :1].expand_as(got)), f"{name}: checksum block not uniform")
        require(torch.equal(case.kernel(a, wt), got), f"{name}: a second call gives other sums")
        err = (got[:, 0, 0].double() - want[:, 0, 0].double()).abs()
        phase("conv-probe", f"{name} y {y_shape} -> {tuple(got.shape)}: max |kernel - plain| {err.max().item():.3e}, "
                            f"max over samples of |kernel - plain| / sum|y| {(err / abs_sum).max().item():.3e} "
                            f"(tolerance {CHECKSUM_RTOL})")
        if not bool((err <= CHECKSUM_RTOL * abs_sum).all()):
            raise AssertionError(f"conv-probe case {name} disagrees with its plain version")
        cp_err = max(cp_err, err.max().item())

    # -- 12. stages 11, 12, 14 and 15's kernels (K7, K8, K10, K11) vs plain --
    pass_arrs = {stage: getattr(train_opt_probe, f"stage{stage}_inputs")(PROBE_BATCH, torch.bfloat16, dev, SEED)
                 for stage in PASS_KERNELS.values()}
    pass_cases = [(key, name, case, pass_arrs[stage][case.inp], pass_arrs[stage][case.weights])
                  for key, stage in PASS_KERNELS.items()
                  for name, case in getattr(conv_probe, f"STAGE{stage}_CASES").items()]
    pass_err = dict.fromkeys(PASS_KERNELS, 0.0)
    for key, name, case, a, wt in pass_cases:
        before = _build.launch_counts()
        got = case.kernel(a, wt)
        torch.cuda.synchronize()
        require(_build.launch_counts() == {**before, key: before[key] + 1}, f"{name}: one {key} launch per call")
        require(torch.equal(case.kernel(a, wt), got), f"{name}: a second call gives another result")
        want = case.plain(a, wt)
        if name == conv_probe.EMIT_CASE:
            require(got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16, (got.shape, want.shape))
            gf, wf = got.float(), want.float()
            ok = bool(((gf - wf).abs() <= K2_ATOL + K2_RTOL * torch.maximum(gf.abs(), wf.abs())).all())
            err, rel_err = max_errors(got, want)
            phase("conv-pass", f"{name} bf16 x{tuple(a.shape)} -> {tuple(got.shape)}: max abs {err:.3e}, max rel "
                               f"{rel_err:.3e}, {(gf != wf).float().mean().item():.2e} of values differ (tolerance "
                               f"one bf16 last bit: rtol 2^-7 + atol {K2_ATOL})")
        else:
            dims = tuple(range(1, want.dim()))
            sums = want.sum(dim=dims)
            abs_sum = want.abs().sum(dim=dims, dtype=torch.float64)
            require(got.shape == (want.shape[0], 8, 128) and torch.isfinite(got).all(), got.shape)
            require(torch.equal(got, got[:, :1, :1].expand_as(got)), f"{name}: checksum block not uniform")
            d = (got[:, 0, 0].double() - sums.double()).abs()
            ok = bool((d <= CHECKSUM_RTOL * abs_sum).all())
            err = d.max().item()
            phase("conv-pass", f"{name} x{tuple(a.shape)} -> y {tuple(want.shape)} -> {tuple(got.shape)}: max "
                               f"|kernel - plain| {err:.3e}, max over results of |kernel - plain| / sum|y| "
                               f"{(d / abs_sum).max().item():.3e} (tolerance {CHECKSUM_RTOL})")
            if name in y_of:
                check_y("conv-pass", name, a, wt, got, want)
        del want
        if not ok:
            raise AssertionError(f"{key} case {name} disagrees with its plain version")
        pass_err[key] = max(pass_err[key], err)

    # -- 13. the probes' CLIs, each with its launch counts -----------------
    torch.cuda.empty_cache()  # phase 12's plain outputs stay cached otherwise, and the probes need the memory
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    probe_out, probe_launches = {}, {}
    for probe, args, kernels in (("pallas_err_probe", [], ["conv_probe"]),
                                 ("train_opt_probe", ["--stages", "11,12,13,14,15"], ["conv_probe", *PASS_KERNELS]),
                                 ("pool_kernel_probe", [], ["time_pool"])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"dfac_tpu_torch.scripts.{probe}", *args],
                              capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
        for line in proc.stdout.strip().splitlines():
            if line.strip():
                phase("probes", f"{probe}: {line.strip()}")
        if proc.returncode != 0:
            raise AssertionError(f"{probe} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        phase("probes", f"{probe}: exit 0 in {time.perf_counter() - t0:.1f}s")
        probe_out[probe] = proc.stdout
        m = re.search(r"^kernel launches: (\{.*\})$", proc.stdout, flags=re.M)
        counts = json.loads(m.group(1)) if m else {}
        if set(counts) != set(_build.LAUNCHES) or not all(counts[k] for k in kernels) or any(
                n for k, n in counts.items() if k not in kernels):
            raise AssertionError(f"{probe} did not run through {kernels} alone: launches {counts}")
        probe_launches[probe] = {k: counts[k] for k in kernels}
    phase("probes", f"launches: {probe_launches}")
    sums = re.findall(r"^== ([gijk]): OK -?\d+\.\d{3}$", probe_out["pallas_err_probe"], flags=re.M)
    if sums != list("gijk"):
        raise AssertionError(f"pallas_err_probe: want four OK lines, got {sums}")
    opt_out = probe_out["train_opt_probe"]
    rows = re.findall(r"^  ([acdfghijk]) .+: +\d+\.\d+ ms  \( *\S+ TF/s\)$", opt_out, flags=re.M)
    rows += re.findall(r"^  (cuDNN conv1 fwd \(control\)) +: +\d+\.\d+ ms$", opt_out, flags=re.M)
    rows += re.findall(r"^  (v[0-4]) .+: +\d+\.\d+ ms$", opt_out, flags=re.M)
    rows += re.findall(r"^  ([hijc]\d) .+: +\d+\.\d+ ms  \( *\S+ TF/s\)$", opt_out, flags=re.M)
    want_rows = [*conv_probe.STAGE12_CASES, *conv_probe.CASES, "cuDNN conv1 fwd (control)", *conv_probe.STAGE11_CASES,
                 *conv_probe.STAGE14_CASES, *conv_probe.STAGE15_CASES]
    if rows != want_rows:
        raise AssertionError(f"train_opt_probe --stages 11,12,13,14,15: want the case lines {want_rows}, got {rows}")
    n_cases = {"conv_probe": len(conv_probe.CASES),
               **{key: len(getattr(conv_probe, f"STAGE{stage}_CASES")) for key, stage in PASS_KERNELS.items()}}
    case_calls = train_opt_probe.calls_per_case()
    if probe_launches["train_opt_probe"] != {k: case_calls * n for k, n in n_cases.items()}:
        raise AssertionError(f"train_opt_probe: want {case_calls} launches per case call of each kernel, got "
                             f"{probe_launches['train_opt_probe']}")
    diffs = dict(re.findall(r"^max \|logit diff\| vs base \((\w+)\): (\S+)$", probe_out["pool_kernel_probe"],
                            flags=re.M))
    rates = re.findall(r"^(reduce_window|depthwise|pallas) *: +[\d,]+ utt/s$", probe_out["pool_kernel_probe"], flags=re.M)
    m = re.search(r"^time_pool launches in the timed pallas runs: (\d+) over (\d+) batches$",
                  probe_out["pool_kernel_probe"], flags=re.M)
    if set(diffs) != {"depthwise", "pallas"} or rates != ["reduce_window", "depthwise", "pallas"] or not m:
        raise AssertionError("pool_kernel_probe: missing result lines")
    if not float(diffs["pallas"]) <= SCORE_ATOL:
        raise AssertionError(f"pool_kernel_probe: pallas logits differ by {diffs['pallas']} (tolerance {SCORE_ATOL})")
    if int(m.group(1)) != 2 * int(m.group(2)):
        raise AssertionError(f"pool_kernel_probe: K5 launched {m.group(1)} times over {m.group(2)} batches")
    phase("probes", f"CLIs: result lines present; pallas logits within {SCORE_ATOL} of reduce_window "
                    f"({diffs['pallas']}); K5 twice per batch ({m.group(1)} over {m.group(2)}); train_opt_probe "
                    f"one launch per case call ({case_calls} calls per case)")

    # -- 14. timing --------------------------------------------------------
    corpus = torch.randn(CORPUS // BATCH, BATCH, n_samples, device=dev, generator=gen)
    rates = chain_rates.rates(chain_rates.slice_runner(folded, corpus, cfg), CORPUS)
    phase("timing", chain_rates.summary("slice", rates)
          + f", {CORPUS} utterances of {n_samples} samples at B={BATCH}, bf16, on {card}")
    del corpus
    feats32 = torch.randn(F32_CORPUS // BATCH, BATCH, N_FRAMES, cfg.feature_dim, device=dev, generator=gen)
    rates = chain_rates.rates(chain_rates.f32_runner(folded, feats32), F32_CORPUS)
    phase("timing", chain_rates.summary("predict f32 chain", rates)
          + f", {F32_CORPUS} feature tensors ({N_FRAMES} x {cfg.feature_dim}) at B={BATCH}, three K2 blocks in f32, "
            f"on {card}")
    del feats32

    ext_dev = 0.1 * torch.randn(EXTRACT_CORPUS // EXTRACT_BATCH, EXTRACT_BATCH, n_samples, device=dev, generator=gen)
    ext_host = ext_dev.reshape(-1, n_samples).cpu().numpy()

    def extract_on_device(method):
        with torch.inference_mode():
            out = [batch_features(wv, cfg, method) for wv in ext_dev]
        torch.cuda.synchronize()
        return out

    for method in METHODS:
        for label, run in (("on device", lambda: extract_on_device(method)),
                           ("host round trip", lambda: lfcc_features_batch(ext_host, cfg, EXTRACT_BATCH, method, dev))):
            rates = chain_rates.rates(run, EXTRACT_CORPUS)
            phase("timing", chain_rates.summary(f"extract {method}, {label}:", rates)
                  + f", {EXTRACT_CORPUS} utterances at B={EXTRACT_BATCH}, on {card}")

    # bounds from this run's shapes (bytes: inputs read once, outputs written once)
    rows, fb_nnz = BATCH * N_FRAMES, int(np.count_nonzero(linear_filterbank(cfg)))
    n_bins, epilogue = cfg.n_fft // 2 + 1, 2 * fb_nnz + 2 * cfg.n_filters * cfg.n_ceps  # per frame, f32
    k1_bytes, dft_flops = wave.numel() * 4 + rows * cfg.n_ceps * 4, 2 * rows * cfg.win_length * 2 * n_bins
    k1_bound = {torch.bfloat16: bound(k1_bytes, bf16=dft_flops, f32=rows * (3 * n_bins + epilogue)),
                torch.float32: bound(k1_bytes, f32=dft_flops + rows * (3 * n_bins + epilogue))}
    def k4_bound(pw):  # power read once, cepstra written once; the banded filters and the DCT in f32
        n = pw.numel() // n_bins
        return bound(pw.numel() * 4 + n * cfg.n_ceps * 4, f32=n * epilogue)

    k1_time = {}
    for dt in (torch.bfloat16, torch.float32):
        k1_time[dt] = in_turns(lambda: cepstra_plain(wave, cfg, dt), lambda: gemm_lfcc_cepstra(wave, cfg, dt))
        (ms, plain_ms), (bnd_ms, bnd_by) = k1_time[dt], k1_bound[dt]
        phase("timing", f"K1 gemm_frontend {str(dt)[6:]} B={BATCH}: kernel {ms:.4f} ms, bound {bnd_ms:.4f} ms "
                        f"({bnd_by}), {bnd_ms / ms:.1%} of the bound's rate; plain {plain_ms:.4f} ms, on {card}")
    # cuBLAS's DFT product alone (frames @ [cos | sin] basis), K1's yardstick: it skips
    # the framing, power, filterbank, log and DCT, so it is no library_ms
    frames_f32 = frames_by_reshape(wave, cfg).reshape(rows, cfg.win_length)
    cos_b, sin_b = host_constants(cfg)[:2]
    basis_f32 = torch.as_tensor(np.concatenate([cos_b, sin_b], axis=1), device=dev)
    for dt in (torch.bfloat16, torch.float32):
        fr, bs = frames_f32.to(dt), basis_f32.to(dt)
        fr @ bs
        control_ms = statistics.mean(cuda_ms(lambda: fr @ bs, 10) for _ in range(2))
        phase("timing", f"K1 control, cuBLAS DFT product alone (one {str(dt)[6:]} torch.matmul, TF32 off) "
                        f"{tuple(fr.shape)} @ {tuple(bs.shape)}: {control_ms:.4f} ms, on {card}")
    del frames_f32
    for b in (BATCH, EXTRACT_BATCH):
        pw = power[:b]
        ms, plain_ms = in_turns(lambda: fb_log_dct_plain(pw, cfg), lambda: fused_fb_log_dct(pw, cfg))
        dev_ms, dev_how = device_ms(lambda: fused_fb_log_dct(pw, cfg), "fb_log_dct_kernel")
        bnd_ms, bnd_by = k4_bound(pw)
        phase("timing", f"K4 fb_log_dct B={b} ({b * N_FRAMES} rows): kernel {ms:.4f} ms in turns, device "
                        f"{dev_ms:.4f} ms a launch ({dev_how}), bound {bnd_ms:.4f} ms ({bnd_by}), "
                        f"{bnd_ms / ms:.1%} of the bound's rate in turns, {bnd_ms / dev_ms:.1%} on the device; "
                        f"plain {plain_ms:.4f} ms, on {card}")
        if b == BATCH:
            k4_ms, k4_plain = ms, plain_ms
    for dt in (torch.bfloat16, torch.float32):
        fft_k4, k1_dt = in_turns(lambda: gemm_lfcc_cepstra(wave, cfg, dt),
                                 lambda: fused_fb_log_dct(power_spectrum(wave, cfg), cfg))
        phase("timing", f"waveform -> cepstra B={BATCH}: rFFT + K4 {fft_k4:.4f} ms, K1 {str(dt)[6:]} "
                        f"{k1_dt:.4f} ms, on {card}")

    def block_bound(x, w, pool, kind):  # bytes in and out once, 9 * Cin * Cout multiply-adds per conv output
        h_out = x.shape[1] // 2 if pool else x.shape[1]
        out_bytes = x.shape[0] * h_out * x.shape[2] * w.shape[-1] * x.element_size()
        conv_rows = x.shape[1] - x.shape[1] % 2 if pool else x.shape[1]
        flops = 2 * x.shape[0] * conv_rows * x.shape[2] * w.numel()
        return bound(x.numel() * x.element_size() + out_bytes, **{kind: flops})

    def cudnn_conv_ms(x, w):  # cuDNN's conv alone (SAME, channels-last; no bias, ReLU or pool), TF32 off
        xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels-last
        wc = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        F.conv2d(xc, wc, padding=1)
        return statistics.mean(cuda_ms(lambda: F.conv2d(xc, wc, padding=1), 10 if x.dtype == torch.bfloat16 else 2)
                               for _ in range(2))

    k2_ms = k2_plain = 0.0
    k2_parts = [block_bound(x, w, pool, "bf16") for x, w, b, pool in k2_inputs]
    for i, ((x, w, b, pool), (bnd_ms, bnd_by)) in enumerate(zip(k2_inputs, k2_parts), 1):
        ms, plain_ms = in_turns(lambda: reference_conv_block(x, w, b, pool), lambda: fused_conv_block(x, w, b, pool))
        k2_ms, k2_plain = k2_ms + ms, k2_plain + plain_ms
        phase("timing", f"K2 conv_block block {i} bf16 x{tuple(x.shape)} pool={pool}: kernel {ms:.4f} ms, "
                        f"bound {bnd_ms:.4f} ms ({bnd_by}), {bnd_ms / ms:.1%} of the bound's rate; plain "
                        f"{plain_ms:.4f} ms, on {card}")
        phase("timing", f"K2 block {i} control, cuDNN conv alone (one bf16 F.conv2d, SAME, channels-last; no "
                        f"bias, ReLU or pool) x{tuple(x.shape)} -> {w.shape[-1]}: {cudnn_conv_ms(x, w):.4f} ms, "
                        f"on {card}")
    x1, w1 = k2_inputs[0][0], k2_inputs[0][1]
    out1 = torch.empty(x1.shape[0], x1.shape[1] // 2, x1.shape[2], w1.shape[-1], device=dev, dtype=torch.bfloat16)
    out1.zero_()
    write_ms = statistics.mean(cuda_ms(out1.zero_, 10) for _ in range(2))
    write_bytes = out1.numel() * out1.element_size()
    phase("timing", f"K2 block 1 control, a write of its output size (out.zero_(), {write_bytes / 1e6:.1f} MB): "
                    f"{write_ms:.4f} ms ({write_bytes / write_ms / 1e9:.3f} TB/s), on {card}")
    out1 = torch.empty(out1.shape, device=dev, dtype=torch.float32)
    out1.zero_()
    write_ms = statistics.mean(cuda_ms(out1.zero_, 10) for _ in range(2))
    write_bytes = out1.numel() * out1.element_size()
    phase("timing", f"K2 block 1 f32 control, a write of its output size (out.zero_(), {write_bytes / 1e6:.1f} MB): "
                    f"{write_ms:.4f} ms ({write_bytes / write_ms / 1e9:.3f} TB/s), on {card}")
    del out1
    k2_f32_ms = k2_f32_plain = 0.0
    k2_f32_parts = [block_bound(x, w, pool, "f32") for x, w, b, pool in k2_f32_inputs]
    for i, ((x, w, b, pool), (bnd_ms, bnd_by)) in enumerate(zip(k2_f32_inputs, k2_f32_parts), 1):
        ms, plain_ms = in_turns(lambda: reference_conv_block(x, w, b, pool), lambda: fused_conv_block(x, w, b, pool),
                                reps=10 if x.shape[-1] == 1 else 2)  # block 1: enough launches to hide the host
        k2_f32_ms, k2_f32_plain = k2_f32_ms + ms, k2_f32_plain + plain_ms
        phase("timing", f"K2 conv_block block {i} f32 x{tuple(x.shape)} pool={pool}: kernel {ms:.4f} ms, "
                        f"bound {bnd_ms:.4f} ms ({bnd_by}), {bnd_ms / ms:.1%} of the bound's rate; plain "
                        f"{plain_ms:.4f} ms, on {card}")
        phase("timing", f"K2 block {i} f32 control, cuDNN conv alone (one f32 F.conv2d, TF32 off, SAME, "
                        f"channels-last; no bias, ReLU or pool) x{tuple(x.shape)} -> {w.shape[-1]}: "
                        f"{cudnn_conv_ms(x, w):.4f} ms, on {card}")

    k5_ms = k5_plain = k5_lib = 0.0
    for x in k5_inputs:
        ms, plain_ms = in_turns(lambda: time_pool_plain(x), lambda: time_pool(x))
        ms2, lib_ms = in_turns(lambda: F.avg_pool2d(x.permute(0, 3, 1, 2), (2, 1)), lambda: time_pool(x))
        k5_ms, k5_plain, k5_lib = k5_ms + ms, k5_plain + plain_ms, k5_lib + lib_ms
        phase("timing", f"K5 time_pool bf16 {tuple(x.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; kernel "
                        f"{ms2:.4f} ms, F.avg_pool2d (channels-last view) {lib_ms:.4f} ms, on {card}")
    # each probe case's bound from this run's inputs (bytes: the part of the input its result depends on, read
    # once, the weights and the result; operations at the rate of the unit that runs them)
    cp_parts = []
    for name, case in conv_probe.CASES.items():
        a, wt = probe_arrs[case.inp], probe_arrs[case.weights]
        t_out = conv_probe.CONV2_ROWS if name in "jk" else conv_probe.CONV1_ROWS
        width = {"g": a.shape[2], "h": conv_probe.CONV1_SLICE_COLS, "i": a.shape[2],
                 "j": conv_probe.CONV2_SLICE_COLS, "k": a.shape[2]}[name]
        # the part of the input the case depends on: rows t + dy; columns f + dx unless they wrap
        read = a.numel() if name == "i" else a[:, : t_out + 2, : width + 2 if name in "hj" else None].numel()
        macs = a.shape[0] * t_out * width * wt.numel()
        cp_parts.append(bound((read + wt.numel()) * 2 + PROBE_BATCH * 8 * 128 * 4, bf16=2 * macs))
    cp_bound = bound_sum(cp_parts)
    pass_parts = {key: [] for key in PASS_KERNELS}
    bf16_bound = {}  # v1, d: the bound at the tensor cores' rate, printed beside their own
    for key, name, case, a, wt in pass_cases:
        if PASS_KERNELS[key] in ("14", "15"):  # only the part of the input the result depends on
            macs, read = chunk_work(name, a, wt)
            pass_parts[key].append(bound((read + wt.numel()) * 2 + PROBE_BATCH * 8 * 128 * 4, bf16=2 * macs))
            continue
        macs, out_bytes = conv_pass_work(name, a, wt)
        if name == "v0":  # reads no weights; an add and an FMA per value on the CUDA cores
            pass_parts[key].append(bound(a.numel() * 2 + out_bytes, f32=3 * a.numel()))
        else:  # v1, d: the CUDA cores' f32 FMAs; the rest the tensor cores'
            io_bytes = (a.numel() + wt.numel()) * 2 + out_bytes
            pass_parts[key].append(bound(io_bytes, **{"f32" if name in FMA_CASES else "bf16": 2 * macs}))
            if name in FMA_CASES:
                bf16_bound[name] = bound(io_bytes, bf16=2 * macs)
    pass_bound = {key: bound_sum(parts) for key, parts in pass_parts.items()}
    case_bound = dict(zip(conv_probe.CASES, cp_parts))
    case_bound.update(zip((name for _, name, *_ in pass_cases), (p for parts in pass_parts.values() for p in parts)))

    def case_line(label, name, ms, plain_ms):
        bnd_ms, bnd_by = case_bound[name]
        unit = ""
        if name in bf16_bound:
            unit = (f" at the f32 rate (CUDA cores); at the bf16 rate {bf16_bound[name][0]:.4f} ms "
                    f"({bf16_bound[name][1]}), {bf16_bound[name][0] / ms:.1%}")
        return (f"{label} {name} B={PROBE_BATCH}: kernel {ms:.4f} ms, bound {bnd_ms:.4f} ms ({bnd_by}), "
                f"{bnd_ms / ms:.1%} of the bound's rate{unit}; plain {plain_ms:.4f} ms, on {card}")

    cp_ms = cp_plain = 0.0
    for name, case in conv_probe.CASES.items():
        a, wt = probe_arrs[case.inp], probe_arrs[case.weights]
        ms, plain_ms = in_turns(lambda: conv_probe.checksum(case.plain(a, wt)), lambda: case.kernel(a, wt))
        cp_ms, cp_plain = cp_ms + ms, cp_plain + plain_ms
        phase("timing", case_line("conv-probe", name, ms, plain_ms))
    pass_ms, pass_plain = dict.fromkeys(PASS_KERNELS, 0.0), dict.fromkeys(PASS_KERNELS, 0.0)
    for key, name, case, a, wt in pass_cases:
        reduce = (lambda y: y) if name == conv_probe.EMIT_CASE else conv_probe.checksum
        ms, plain_ms = in_turns(lambda: reduce(case.plain(a, wt)), lambda: case.kernel(a, wt))
        pass_ms[key], pass_plain[key] = pass_ms[key] + ms, pass_plain[key] + plain_ms
        phase("timing", case_line(key, name, ms, plain_ms))
        if name == "v0":  # a ~0.03 ms kernel behind its wrapper's host work: its device time too
            dev_ms, dev_how = device_ms(lambda: case.kernel(a, wt), "sum_sq_checksum")
            phase("timing", f"{key} v0 B={PROBE_BATCH}: device {dev_ms:.4f} ms a launch ({dev_how}; "
                            f"sum_sq_checksum alone), {case_bound[name][0] / dev_ms:.1%} of the bound's rate, "
                            f"on {card}")
    x11, w11 = pass_arrs["11"]["x"], pass_arrs["11"]["w"]
    train_opt_probe.conv1_control(x11, w11)
    control_ms = statistics.mean(cuda_ms(lambda: train_opt_probe.conv1_control(x11, w11), 10) for _ in range(2))
    phase("timing", f"stage 11 control, cuDNN conv1 fwd (one bf16 F.conv2d, SAME, NHWC out) B={PROBE_BATCH}: "
                    f"{control_ms:.4f} ms, on {card}")
    # cuDNN's VALID conv at j's and j5's shapes: a yardstick, not the same function (it writes y, the
    # kernel only sums it), so no library_ms
    for name, h, w, t_out, f_out in (("j", probe_arrs["h1"], probe_arrs["w2"], conv_probe.CONV2_ROWS,
                                      conv_probe.CONV2_SLICE_COLS),
                                     ("j5", pass_arrs["15"]["h2arr"], pass_arrs["15"]["w3"], conv_probe.CONV3_ROWS,
                                      conv_probe.CONV3_COLS)):
        hc = h[:, : t_out + 2, : f_out + 2].contiguous().permute(0, 3, 1, 2)  # NCHW view of NHWC: channels-last
        wc = w.reshape(3, 3, *w.shape[1:]).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        F.conv2d(hc, wc)
        control_ms = statistics.mean(cuda_ms(lambda: F.conv2d(hc, wc), 10) for _ in range(2))
        phase("timing", f"{name} control, cuDNN conv alone (one bf16 F.conv2d, VALID, channels-last, TF32 off; "
                        f"computes more: it writes y {(hc.shape[0], t_out, f_out, w.shape[-1])} in bf16, the kernel "
                        f"only sums y) B={PROBE_BATCH}: {control_ms:.4f} ms, on {card}")
        del hc

    k2_bound = bound_sum(k2_parts)
    k2_f32_bound = bound_sum(k2_f32_parts)
    k5_bound = bound_sum(bound((x.shape[1] // 2) * x[:, 0].numel() * 2 * 3) for x in k5_inputs)

    def entry(name, source, replaces, n_launches, err, ms, plain_ms, bnd, library_ms=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": n_launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    kernels = [
        entry("gemm_frontend", "dfac_tpu_torch/csrc/gemm_frontend.cu", "dfac_tpu/ops/pallas/gemm_frontend.py:71",
              launches["gemm_frontend"], k1_err[torch.bfloat16], *k1_time[torch.bfloat16], k1_bound[torch.bfloat16]),
        entry("gemm_frontend_f32", "dfac_tpu_torch/csrc/gemm_frontend.cu", "dfac_tpu/ops/pallas/gemm_frontend.py:71",
              ext_launches["gemm"]["gemm_frontend"], k1_err[torch.float32], *k1_time[torch.float32],
              k1_bound[torch.float32]),
        entry("conv_block", "dfac_tpu_torch/csrc/conv_block.cu", "dfac_tpu/ops/pallas/conv_block.py:142",
              launches["conv_block"], k2_err, k2_ms, k2_plain, k2_bound),
        entry("conv_block_f32", "dfac_tpu_torch/csrc/conv_block.cu", "dfac_tpu/ops/pallas/conv_block.py:142",
              f32_launches["conv_block"], k2_f32_err, k2_f32_ms, k2_f32_plain, k2_f32_bound),
        entry("fb_log_dct", "dfac_tpu_torch/csrc/lfcc_kernel.cu", "dfac_tpu/ops/pallas/lfcc_kernel.py:41",
              ext_launches["fft-pallas"]["fb_log_dct"], k4_err, k4_ms, k4_plain, k4_bound(power)),
        entry("time_pool", "dfac_tpu_torch/csrc/pool_kernel.cu", "scripts/pool_kernel_probe.py:81",
              probe_launches["pool_kernel_probe"]["time_pool"], k5_err, k5_ms, k5_plain, k5_bound, k5_lib),
        entry("conv_probe", "dfac_tpu_torch/csrc/conv_probe.cu",
              "scripts/train_opt_probe.py:1108, scripts/pallas_err_probe.py:44",
              probe_launches["pallas_err_probe"]["conv_probe"] + probe_launches["train_opt_probe"]["conv_probe"],
              cp_err, cp_ms, cp_plain, cp_bound),
        *(entry(key, "dfac_tpu_torch/csrc/conv_probe.cu", PASS_REPLACES[key], probe_launches["train_opt_probe"][key],
                pass_err[key], pass_ms[key], pass_plain[key], pass_bound[key]) for key in PASS_KERNELS),
    ]
    for k in kernels:
        phase("timing", f"{k['name']}: kernel {k['ms']:.4f} ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
                        f"{k['bound_ms'] / k['ms']:.1%} of the bound's rate, on {card}")

    return kernels, kind, card, dev


def main() -> int:
    done = kernel_phases()
    if done is None:
        return 1
    kernels, kind, card, dev = done
    import torch

    # -- 15. training -------------------------------------------------------
    # phases 1-14's tensors went with their frame; hand their cached blocks back, so that the train
    # CLIs' processes and the B=512 steps find the card's memory
    torch.cuda.empty_cache()
    phase("train", f"device memory before training: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
                   f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    train_phase(dev, card)
    # -- 16. submission -----------------------------------------------------
    torch.cuda.empty_cache()
    submission_phase(dev, card)
    # -- 17. the alternative trainers -------------------------------------------------
    torch.cuda.empty_cache()
    alt_trainers_phase(dev, card)
    # -- 18. the zoo, bf16 training and the sweep CLIs ------------------------------
    torch.cuda.empty_cache()
    zoo_phase(dev, card)
    # -- 19. int8 serving and the data tools ------------------------------------------
    torch.cuda.empty_cache()
    kernels.extend(int8_tools_phase(dev, card))
    # -- 20. the remainder of single-device training ------------------------------------
    torch.cuda.empty_cache()
    train_rest_phase(dev, card)
    # -- 21. data-parallel training -------------------------------------------------------
    torch.cuda.empty_cache()
    data_parallel_phase(dev, card)
    # -- 22. multi-host training and sharded serving ----------------------------------------
    torch.cuda.empty_cache()
    multihost_phase(dev, card)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
