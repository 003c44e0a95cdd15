"""Shared CLI plumbing: the flag groups of the reference scripts.

Counterpart of the subset of :mod:`dfac_tpu.cli.common` that the ported
CLIs use.
"""

from __future__ import annotations

import argparse
import contextlib
import random

import numpy as np
import torch

from dfac_tpu_torch.data.augment import AugmentConfig


def add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--train-features", default="data/train/features.pkl")
    p.add_argument("--train-labels", default="data/train/labels.pkl")
    p.add_argument("--dev-features", default="data/dev/features.pkl")
    p.add_argument("--dev-labels", default="data/dev/labels.pkl")


def add_swap_tf_args(p: argparse.ArgumentParser) -> None:
    """Mutually-exclusive --swap-tf/--no-swap-tf pair (reference
    ``src/train.py:232-245``; default swap **on**)."""
    g = p.add_mutually_exclusive_group()
    g.add_argument("--swap-tf", dest="swap_tf", action="store_true",
                   help="swap time and feature dimensions (T <-> F) (default)")
    g.add_argument("--no-swap-tf", dest="swap_tf", action="store_false",
                   help="disable time/feature swap")
    p.set_defaults(swap_tf=True)


def add_augment_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--spec-augment", action="store_true",
                   help="enable SpecAugment during training")
    p.add_argument("--time-mask-ratio", type=float, default=0.2)
    p.add_argument("--feature-mask-ratio", type=float, default=0.1)
    p.add_argument("--feature-mask", action="store_true",
                   help="enable feature masking in addition to time masking")
    p.add_argument("--time-shift", action="store_true")
    p.add_argument("--time-shift-ratio", type=float, default=0.1)
    p.add_argument("--channel-drop", action="store_true")
    p.add_argument("--channel-drop-prob", type=float, default=0.1)
    p.add_argument("--gaussian-jitter", action="store_true")
    p.add_argument("--gaussian-jitter-std", type=float, default=0.01)


def augment_config_from_args(args) -> AugmentConfig:
    return AugmentConfig(
        spec_augment=args.spec_augment,
        time_mask_ratio=args.time_mask_ratio,
        feature_mask_ratio=args.feature_mask_ratio,
        feature_mask=args.feature_mask,
        time_shift=args.time_shift,
        time_shift_ratio=args.time_shift_ratio,
        channel_drop=args.channel_drop,
        channel_drop_prob=args.channel_drop_prob,
        gaussian_jitter=args.gaussian_jitter,
        gaussian_jitter_std=args.gaussian_jitter_std,
    )


def set_seed(seed: int) -> None:
    """Seed the host generators and torch's default generators (every
    device). The trainer's own draws use generators of its own, seeded
    from the same value."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def add_multihost_args(p: argparse.ArgumentParser, extra_help: str = "") -> None:
    """The JAX CLIs' ``--multihost`` flag group (``dfac_tpu/cli/common.py:30-41``)."""
    p.add_argument("--multihost", action="store_true",
                   help="multi-host execution: run one copy of this CLI per host, joined at "
                        "--coordinator-address (one rank per card of the host, one with --device cpu). DP over "
                        "ALL global devices; artifacts from the coordinator only"
                        + (". " + extra_help if extra_help else ""))
    p.add_argument("--coordinator-address", default=None, metavar="HOST:PORT",
                   help="with --multihost: the rank-0 coordinator (process 0 listens there)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="with --coordinator-address: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="with --coordinator-address: this process's rank")


def init_multihost(args):
    """Join the cluster (:func:`dfac_tpu_torch.parallel.multihost.initialize`)
    and default ``args.data_parallel`` to the GLOBAL rank count; a larger
    count that is not the world's is refused with the JAX package's
    ``local_row_range`` message. Returns the
    :class:`~dfac_tpu_torch.parallel.multihost.Cluster`."""
    from dfac_tpu_torch.parallel import multihost as mh

    cluster = mh.initialize(args.coordinator_address, args.num_processes, args.process_id, args.device)
    if not args.data_parallel:
        args.data_parallel = cluster.world
    elif args.data_parallel > 1 and args.data_parallel != cluster.world:
        cluster.close()
        raise SystemExit(f"--data-parallel {args.data_parallel} over {cluster.world} global ranks: "
                         + mh.SPAN_MESSAGE)
    return cluster


@contextlib.contextmanager
def joined(args):
    """The cluster this process joins under ``--multihost`` (:func:`init_multihost`),
    closed on exit; None without the flag."""
    if not args.multihost:
        yield None
        return
    cluster = init_multihost(args)
    try:
        yield cluster
    finally:
        cluster.close()


def refuse_unported_training(args) -> None:
    """Exit non-zero on ``--checkpoint-format orbax``: orbax checkpoint
    directories are not ported by design (``orbax.checkpoint`` imports JAX;
    ROADMAP.md, "Do not port")."""
    if args.checkpoint_format == "orbax":
        raise SystemExit("--checkpoint-format orbax: not ported to dfac_tpu_torch (orbax imports JAX; the JAX "
                         "package converts an orbax directory to a pickle checkpoint; see ROADMAP.md)")


DATA_PARALLEL_HELP = ("data-parallel training over N devices: one process per device (NCCL on the card, gloo with "
                      "--device cpu), BatchNorm synced across them; --batch-size is the global batch")


def run_training(fit, args, *data, cluster=None):
    """``fit(args, *data)`` in this process, on N ranks with
    ``--data-parallel N > 1`` (:func:`dfac_tpu_torch.parallel.launch`; the
    datasets in shared memory), or on this host's ranks of a ``--multihost``
    ``cluster``; the result of this process's first rank (rank 0's in the
    first two). The data was read here first, so a missing file fails
    before any rank starts."""
    if cluster is not None:
        return cluster.run(fit, args, *data)
    if args.data_parallel > 1:
        from dfac_tpu_torch.parallel import launch

        return launch(fit, args.data_parallel, args.device, args, *data)
    return fit(args, *data)


def train_device(args):
    """The device a fit runs on: ``--device``, or a data-parallel rank's own."""
    if args.data_parallel > 1 or args.multihost:
        from dfac_tpu_torch.parallel.data_parallel import rank_device

        return rank_device(args.device)
    return args.device


CHUNK_HELP = ("stream the epoch in chunks of G batches through pinned memory (the upload overlapped with the "
              "previous chunk's steps) — for corpora larger than the card's memory; same batches and generator "
              "draws as the default per-batch loop")
INGEST_HELP = ("compress the chunked-streaming host->device upload: bf16 halves the link bytes, int8 quarters "
               "them (per-row scales, dequantized on the card before the step) - the remedy for ingest-bound "
               "chunked training; quality impact EER-gated (tests/test_chunked.py). Requires "
               "--resident-chunk-batches")
FREEZE_HELP = ("fast-numerics recipe: freeze BatchNorm (running-stats forward, no stat updates) for epochs after "
               "FRAC of the schedule (0 disables)")


def add_stream_args(p: argparse.ArgumentParser, fused_help: str) -> None:
    """The JAX training CLIs' ``--fused-fit``, ``--resident-chunk-batches``
    and ``--chunk-ingest``."""
    p.add_argument("--fused-fit", action="store_true", help=fused_help)
    p.add_argument("--resident-chunk-batches", type=int, default=0, metavar="G", help=CHUNK_HELP)
    p.add_argument("--chunk-ingest", choices=["f32", "bf16", "int8"], default="f32", help=INGEST_HELP)


def check_stream_args(p: argparse.ArgumentParser, args) -> None:
    """The JAX training CLIs' conflicts (``dfac_tpu/cli/train.py:104-111``)."""
    if args.fused_fit and args.resident_chunk_batches:
        p.error("--fused-fit compiles the whole run over a device-resident "
                "corpus; it cannot stream chunks — drop one of "
                "--fused-fit/--resident-chunk-batches")
    if args.device_resident and args.resident_chunk_batches:
        p.error("--device-resident uploads the whole corpus once; "
                "--resident-chunk-batches streams it — pick one")
