"""The alternative trainers' CLIs and the CAE dashboard in the PyTorch port.

Each flag set that the training CLIs once refused runs in ``train_cae``
and ``train_detector``: orbax checkpoints (not ported) and ``--multihost``
without ``--coordinator-address`` exit non-zero before any data is read;
the data-parallel, chunked, fused and freeze-tail flags go on to read the
data, so a missing split stops them (``train_detector`` builds its
configuration first, which refuses ``--chunk-ingest int8`` without
``--resident-chunk-batches`` with the JAX package's error). The CAE dashboards print the reference's lines,
and ``create_cae_visualizer("rich")`` falls back to the plain dashboard
where ``rich`` cannot be imported. The CLIs' parity with the JAX CLIs is
in ``tests/test_torch_port_cae_train.py`` and
``tests/test_torch_port_detector.py``.
"""

import sys

import pytest

from dfac_tpu_torch.cli import train_cae, train_detector
from dfac_tpu_torch.obs import cae_dashboard
from dfac_tpu_torch.obs.base import BatchMetrics, EpochMetrics, TrainingConfig
from dfac_tpu_torch.obs.noop import NoOpVisualizer

REFUSED = [
    ("--fused-fit",),
    ("--resident-chunk-batches", "4"),
    ("--chunk-ingest", "bf16", "--resident-chunk-batches", "4"),
    ("--chunk-ingest", "int8"),
    ("--data-parallel", "2"),
    ("--multihost",),
    ("--bn-freeze-after", "0.5"),
    ("--train-fast",),
    ("--checkpoint-format", "orbax"),
]


STILL_REFUSED = {"--multihost", "--checkpoint-format"}


@pytest.mark.parametrize("cli", [train_cae, train_detector], ids=["train_cae", "train_detector"])
@pytest.mark.parametrize("flags", REFUSED, ids=[" ".join(f) for f in REFUSED])
def test_unported_flags_exit_not_yet_ported(cli, flags, tmp_path):
    missing = str(tmp_path / "missing")
    argv = ["--device", "cpu", *flags]
    argv += (["--data-dir", missing] if cli is train_detector else
             ["--train-features", missing, "--train-labels", missing, "--checkpoint-dir", missing])
    if flags[0] in STILL_REFUSED:  # refused before any data is read: orbax, and --multihost with no coordinator
        msg = "--coordinator-address HOST:PORT" if flags[0] == "--multihost" else "not ported to dfac_tpu_torch"
        with pytest.raises(SystemExit, match=msg) as exc:
            cli.main(argv)
        assert exc.value.code not in (0, None)
    elif cli is train_detector and flags == ("--chunk-ingest", "int8"):
        with pytest.raises(ValueError, match="needs resident_chunk_batches > 0"):
            cli.main(argv)
    else:  # ported: the CLI goes on to read the data
        with pytest.raises(FileNotFoundError):
            cli.main(argv)
    assert not (tmp_path / "missing").exists()


def test_bf16_training_is_refused_and_bf16_scoring_is_not(tmp_path):
    """``--bf16`` is accepted with training (the detector trains in bf16)
    and with scoring alone (the bf16 chain): both go on to read the data,
    so a missing split is what stops them."""
    for epochs in ("1", "0"):
        with pytest.raises(FileNotFoundError):
            train_detector.main(["--data-dir", str(tmp_path), "--epochs", epochs, "--bf16", "--fast",
                                 "--device", "cpu"])


def _drive(vis, early_stop=2):
    vis.on_training_start(TrainingConfig(device="cpu", model="cae", epochs=3, batch_size=4, learning_rate=1e-4,
                                         weight_decay=1e-4, early_stop_patience=early_stop))
    history = []
    for epoch, (val, best, no_imp) in enumerate([(0.5, True, 0), (0.6, False, 1), (0.7, False, 2)], 1):
        with vis.on_epoch_start(epoch, 3) as ctx:
            if getattr(ctx, "wants_updates", True):
                ctx.update_batch(BatchMetrics(0, 0.9, 4))
        m = EpochMetrics(epoch=epoch, train_loss=0.9 / epoch, dev_loss=val, dev_eer=None, is_best=best,
                         improved=best, epochs_no_improve=no_imp, learning_rate=1e-4, epoch_seconds=0.1)
        vis.on_epoch_end(m, history[-1] if history else None)
        history.append(m)
    vis.on_training_end(history)


def test_plain_dashboard_prints_the_reference_lines(capsys):
    _drive(cae_dashboard.CAEPlainDashboard())
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "Training on cpu for up to 3 epochs (early stop patience=2)"
    assert lines[1] == "-" * 60
    assert lines[2] == "  epoch   1  train_mse=0.900000  val_mse=0.500000  lr=1.00e-04  no_improve=0 *"
    assert lines[3] == "  epoch   2  train_mse=0.450000  val_mse=0.600000  lr=1.00e-04  no_improve=1"
    assert "Early stopping at epoch 3 (no improvement in 2 epochs)" in lines
    assert lines[-1] == "Best val MSE: 0.500000 (epoch 1)"


def test_rich_dashboard_runs_and_falls_back_to_plain_without_rich(monkeypatch, capsys):
    pytest.importorskip("rich")
    vis = cae_dashboard.create_cae_visualizer("rich")
    assert isinstance(vis, cae_dashboard.CAEDashboard)
    _drive(vis)
    out = capsys.readouterr().out
    assert "CAE Training" in out and "Best val MSE 0.500000 at epoch 1" in out
    monkeypatch.setitem(sys.modules, "rich.console", None)  # "import rich.console" now raises ImportError
    assert isinstance(cae_dashboard.create_cae_visualizer("rich"), cae_dashboard.CAEPlainDashboard)
    assert isinstance(cae_dashboard.create_cae_visualizer("plain"), cae_dashboard.CAEPlainDashboard)
    assert isinstance(cae_dashboard.create_cae_visualizer("noop"), NoOpVisualizer)
    with pytest.raises(ValueError, match="unknown CAE visualizer"):
        cae_dashboard.create_cae_visualizer("fancy")
