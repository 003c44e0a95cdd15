"""The training CLIs' ``--data-parallel`` in the PyTorch port, on two gloo ranks on the CPU.

``train``, ``train_cae`` and ``train_detector`` with ``--data-parallel 2
--device cpu`` run as five processes at once on one synthetic corpus
(one intra-op thread a rank): each exits 0, prints its lines once (rank 0
alone prints) and writes one set of artifacts; ``train`` on the corpus's
``.npy`` stores prints what it prints on the pickles; a fused data-parallel fit
fails on its ranks and the command exits non-zero with the JAX package's
message. In process: the device count is checked against the cards with
``make_mesh``'s message after the data is read, and ``--multihost``
refuses what the JAX CLIs refuse. The runs' numbers are held to the JAX package's in
``tests/test_torch_port_dp.py``.
"""

import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from dfac_tpu_torch.cli import train as ttrain
from dfac_tpu_torch.cli import train_cae, train_detector
from dfac_tpu_torch.data.pipeline import ArrayDataset, load_dataset
from dfac_tpu_torch.io.npy_store import save_npy_dataset
from dfac_tpu_torch.parallel import data_parallel as dp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_, T_ = 20, 40  # the CAE needs 16 or more of each
SPLITS = {"train": 24, "dev": 12, "test2": 8}
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_cli_data")
    rng = np.random.default_rng(0)
    for split, n in SPLITS.items():
        feats = rng.normal(size=(n, F_, T_)).astype(np.float32)
        labels = np.arange(n) % 2
        feats[labels == 1, :4] += 0.5
        ids = [f"{split}{i}" for i in range(n)]
        (root / split).mkdir()
        pd.DataFrame({"uttid": ids, "features": [torch.from_numpy(m) for m in feats]}).to_pickle(
            root / split / "features.pkl")
        pd.DataFrame({"uttid": ids, "label": labels}).to_pickle(root / split / "labels.pkl")
        save_npy_dataset(ArrayDataset(ids, feats, labels.astype(np.int32)), str(root / split / "store"))
    return root


def _split_flags(data_dir, features="features.pkl"):
    """The splits' flags: the pickles, or with ``features="store"`` the features' ``.npy`` stores."""
    return ["--train-features", str(data_dir / "train" / features),
            "--train-labels", str(data_dir / "train" / "labels.pkl"),
            "--dev-features", str(data_dir / "dev" / features),
            "--dev-labels", str(data_dir / "dev" / "labels.pkl")]


@pytest.fixture(scope="module")
def runs(data_dir, tmp_path_factory):
    """The CLI processes, started together; ``{name: (rc, stdout, stderr, dir)}``."""
    out = tmp_path_factory.mktemp("dp_cli_out")
    dp = ["--data-parallel", "2", "--device", "cpu", "--epochs", "2"]
    commands = {
        "train": ["dfac_tpu_torch.cli.train", *_split_flags(data_dir), *dp, "--batch-size", "8", "--in-features",
                  str(F_), "--no-rich", "--checkpoint-dir", str(out / "train")],
        "train_npy": ["dfac_tpu_torch.cli.train", *_split_flags(data_dir, "store"), *dp, "--batch-size", "8",
                      "--in-features", str(F_), "--no-rich", "--checkpoint-dir", str(out / "train_npy")],
        "train_cae": ["dfac_tpu_torch.cli.train_cae", *_split_flags(data_dir), *dp, "--batch-size", "4",
                      "--base-channels", "4", "--no-rich", "--checkpoint-dir", str(out / "train_cae")],
        "train_detector": ["dfac_tpu_torch.cli.train_detector", "--data-dir", str(data_dir), *dp, "--batch-size",
                           "8", "--hidden", "16", "--ema", "--ckpt-path", str(out / "train_detector" / "det.ckpt"),
                           "--prediction-pkl", str(out / "train_detector" / "prediction.pkl")],
        "fused": ["dfac_tpu_torch.cli.train", *_split_flags(data_dir), *dp, "--batch-size", "8", "--in-features",
                  str(F_), "--quiet", "--fused-fit", "--checkpoint-dir", str(out / "fused")],
    }
    (out / "train_detector").mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = {k: subprocess.Popen([sys.executable, "-m", *cmd], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True, cwd=ROOT, env=env) for k, cmd in commands.items()}
    results = {}
    try:
        for k, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            results[k] = (p.returncode, stdout, stderr, out / k)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return results


def _ok(runs, name):
    rc, stdout, stderr, d = runs[name]
    assert rc == 0, stderr[-3000:]
    return stdout.splitlines(), d


def test_train_cli_data_parallel(runs):
    lines, d = _ok(runs, "train")
    assert sum(ln.startswith("best dev EER: ") for ln in lines) == 1 and lines[-1].startswith("best dev EER: ")
    for epoch in (1, 2):
        assert sum(ln.startswith(f"Epoch {epoch}: train_loss=") for ln in lines) == 1
    assert sorted(os.listdir(d)) == ["cnn2d_best.ckpt", "cnn2d_last.ckpt"]


def test_train_cli_data_parallel_on_npy_stores(runs, data_dir):
    """The splits as memory-mapped ``.npy`` stores: the ranks map the files
    again (no shared-memory copy) and the run prints what the pickles' run
    prints, bit for bit, and writes the same files."""
    ds = load_dataset(str(data_dir / "train" / "store"), str(data_dir / "train" / "labels.pkl"))
    shared = dp.share_dataset(ds)
    assert not isinstance(shared.features, torch.Tensor)  # sent by its file, not copied
    local = dp.local_dataset(pickle.loads(pickle.dumps(shared)))
    assert isinstance(local.features, np.memmap)
    np.testing.assert_array_equal(local.features, ds.features)
    lines, d = _ok(runs, "train_npy")
    want, want_d = _ok(runs, "train")

    def numbers(out):  # the epoch lines and the result, without the throughput
        return [re.sub(r" +[0-9.]+ utt/s", "", ln) for ln in out if ln.startswith(("Epoch ", "best dev EER: "))]

    assert len(numbers(lines)) == 3 and numbers(lines) == numbers(want)
    assert sorted(os.listdir(d)) == sorted(os.listdir(want_d)) == ["cnn2d_best.ckpt", "cnn2d_last.ckpt"]


def test_train_cae_cli_data_parallel(runs):
    lines, d = _ok(runs, "train_cae")
    assert sum(ln.startswith("best val reconstruction MSE: ") for ln in lines) == 1
    assert lines[-1].startswith("best val reconstruction MSE: ")
    assert sum("epoch   1" in ln for ln in lines) == 1
    assert sorted(os.listdir(d)) == ["cae_best.ckpt", "cae_last.ckpt", "normalizer.npz"]


def test_train_detector_cli_data_parallel(runs):
    lines, d = _ok(runs, "train_detector")
    assert [ln.split(":")[0] for ln in lines] == ["Training done. Best dev EER", "Saved prediction file -> "
                                                  + str(d / "prediction.pkl") + "  shape", "EER on split 'test2'"]
    assert sorted(os.listdir(d)) == ["det.ckpt", "prediction.pkl"]
    assert len(pd.read_pickle(d / "prediction.pkl")) == SPLITS["test2"]


def test_a_failing_rank_fails_the_command(runs):
    """``--fused-fit`` with ``--data-parallel``: each rank raises the JAX
    package's ``ValueError``, the command exits non-zero with it and writes
    nothing."""
    rc, _, stderr, d = runs["fused"]
    assert rc != 0
    assert "fit_fused with data_parallel is the MULTIHOST GSPMD path" in stderr
    assert not os.path.exists(d)


def test_device_count_is_checked_after_the_data_is_read(data_dir, tmp_path):
    """No card here: ``--device cuda`` with two ranks is ``make_mesh``'s
    refusal, after the splits were read (a missing split fails first)."""
    argv = [*_split_flags(data_dir), "--data-parallel", "2", "--in-features", str(F_), "--checkpoint-dir",
            str(tmp_path / "ck")]
    with pytest.raises(ValueError, match=r"^mesh 2x1 needs 2 devices, only 0 available$"):
        ttrain.main(argv)
    with pytest.raises(FileNotFoundError):
        ttrain.main([*argv, "--dev-features", str(tmp_path / "missing.pkl")])
    assert not (tmp_path / "ck").exists()


@pytest.mark.parametrize("cli", [ttrain, train_cae, train_detector], ids=["train", "train_cae", "train_detector"])
def test_multihost_is_still_refused(cli, data_dir, tmp_path):
    """``--multihost`` is ported (``tests/test_torch_port_multihost.py``);
    what the JAX CLIs refuse stays refused, with their messages: no
    ``--coordinator-address`` (the three flags named), and ``--data-parallel
    1`` in a one-process cluster (the trainer's config). Nothing is
    written, and the process group is gone afterwards."""
    import torch.distributed as dist

    with pytest.raises(SystemExit, match="--coordinator-address HOST:PORT") as exc:
        cli.main(["--multihost", "--data-parallel", "2", "--device", "cpu"])
    assert exc.value.code not in (0, None)
    cluster = ["--multihost", "--coordinator-address", f"127.0.0.1:{dp.free_port()}", "--num-processes", "1",
               "--process-id", "0", "--data-parallel", "1", "--device", "cpu"]
    ck = tmp_path / "ck"
    argv = {ttrain: [*_split_flags(data_dir), "--in-features", str(F_), "--quiet", "--checkpoint-dir", str(ck)],
            train_cae: [*_split_flags(data_dir), "--quiet", "--checkpoint-dir", str(ck)],
            train_detector: ["--data-dir", str(data_dir), "--ckpt-path", str(ck / "det.ckpt"),
                             "--prediction-pkl", str(ck / "prediction.pkl")]}[cli]
    with pytest.raises(ValueError, match="is data-parallel over the pod — set data_parallel to the GLOBAL device count"):
        cli.main(cluster + argv)
    assert not dist.is_initialized()
    assert not ck.exists()
