"""The plain references agree with the program on the CPU at small sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.lib import seeded
from perfbench.reference import cae as cae_ref
from perfbench.reference import cnn2d as cnn_ref

DIMS = {"in_features": 16, "frames": 17, "base_channels": 4}


def weights(leaves, seed=3):
    return seeded.state_dict(leaves, torch.Generator().manual_seed(seed), torch.device("cpu"))


def corpus(n=12, seed=4):
    return seeded.labeled_corpus(n, 16, 17, torch.Generator().manual_seed(seed), torch.device("cpu"))


def test_cnn2d_eval_matches_the_eval_model():
    from dfac_tpu_torch.models import model_from_state_dict

    sd = weights(cnn_ref.leaves(DIMS))
    feats, _ = corpus()
    model = model_from_state_dict("cnn2d", sd).eval()
    with torch.no_grad():
        want = model(feats.transpose(1, 2)).reshape(-1)
    assert torch.allclose(cnn_ref.eval_logits(sd, feats), want, atol=1e-5, rtol=1e-5)


def test_cnn2d_scores_match_predict_fast():
    from dfac_tpu_torch.models.fast_infer import predict_scores_fast

    sd = weights(cnn_ref.leaves(DIMS))
    feats, labels = corpus()
    ds = seeded.host_dataset(feats, labels, "u")
    got = predict_scores_fast(sd, ds, torch.device("cpu"), 8, compute_dtype=torch.float32)
    want = cnn_ref.sigmoid(cnn_ref.logits_of_rows(sd, ds.features, "cpu"))
    assert np.abs(got - want).max() < 1e-6


def test_cae_mse_matches_the_autoencoder():
    from dfac_tpu_torch.data.normalizer import FeatureNormalizer
    from dfac_tpu_torch.models import model_from_state_dict
    from dfac_tpu_torch.models.cae import reconstruction_mse

    sd = weights(cae_ref.leaves(DIMS))
    feats, labels = corpus()
    mean, std = seeded.bonafide_normalizer(feats, labels)
    fitted = FeatureNormalizer().fit(feats.transpose(1, 2)[torch.as_tensor(labels == 1)].numpy())
    assert np.allclose(mean, fitted.mean, atol=1e-6) and np.allclose(std, fitted.std, rtol=1e-5)
    x = (feats.transpose(1, 2) - torch.as_tensor(mean)) / torch.as_tensor(std)
    model = model_from_state_dict("cae", sd).eval()
    with torch.no_grad():
        want = reconstruction_mse(model(x)[0], x)
    got = cae_ref.mse(sd, feats, torch.as_tensor(mean), torch.as_tensor(std))
    assert torch.allclose(got, want, rtol=1e-5)


def test_fusion_and_eer_match_the_program():
    from dfac_tpu_torch.ensemble.hybrid import fuse_scores
    from dfac_tpu_torch.ops.eer import calculate_eer

    rng = np.random.default_rng(0)
    a, b = rng.random(50), rng.random(50) * 3
    labels = (rng.random(50) > 0.5).astype(np.int32)
    assert np.array_equal(cae_ref.fuse(a, b, 0.8), fuse_scores(a, b, 0.8))
    assert cnn_ref.eer(a, labels) == calculate_eer(a, labels)[0]
    ties = np.round(a, 1)
    assert cnn_ref.eer(ties, labels) == calculate_eer(ties, labels)[0]


@pytest.mark.parametrize("drop", [False, True])
def test_train_steps_match_the_trainer(drop):
    """Three steps of the program's trainer against the reference's, on the same
    weights, rows and draws; ``drop`` shows the reference's planted fault
    moves the loss."""
    from dfac_tpu_torch.data.augment import AugmentConfig
    from dfac_tpu_torch.train.loop import TrainConfig, Trainer

    recipe = {"lr": 1e-3, "weight_decay": 0.01, "label_smoothing": 0.05, "dropout": 0.2,
              "augment": {"spec_augment": True, "time_mask_ratio": 0.2, "feature_mask": True,
                          "feature_mask_ratio": 0.1, "time_shift": True, "time_shift_ratio": 0.1,
                          "channel_drop": True, "channel_drop_prob": 0.05, "gaussian_jitter": True,
                          "gaussian_jitter_std": 0.005}}
    sd = weights(cnn_ref.leaves(DIMS))
    feats, labels = corpus(24)
    cfg = TrainConfig(model="cnn2d", in_features=16, batch_size=8, lr=1e-3, weight_decay=0.01,
                      label_smoothing=0.05, dropout=0.2, seed=11, augment=AugmentConfig(**recipe["augment"]))
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state(state_dict=sd)
    y = torch.as_tensor(labels, dtype=torch.float32)
    batches = [(feats[i : i + 8], y[i : i + 8]) for i in range(0, 24, 8)]
    losses = []
    for f, l in batches:
        s, c = trainer.train_step(f, l, torch.ones(8))
        losses.append(float(s / c))
    got = cnn_ref.train_steps({k: v for k, v in sd.items() if v.is_floating_point()}, batches, recipe, 11, DIMS,
                              drop_half=drop)
    if drop:
        assert abs(got["losses"][0] - losses[0]) > 1e-4
        return
    assert np.allclose(got["losses"], losses, rtol=1e-6)
    # a conv's bias has no gradient under BatchNorm but round-off, which Adam scales to a full step:
    # those leaves move by round-off alone, on either side
    norms = {k: float(g.norm()) for k, g in got["first_grads"].items()}
    median = np.median(list(norms.values()))
    assert {k for k, n in norms.items() if n < 1e-3 * median} == {"conv.0.bias", "conv.5.bias", "conv.10.bias"}
    for k, v in trainer.model.named_parameters():
        if norms[k] >= 1e-3 * median:
            assert torch.allclose(got["params"][k], v.detach(), atol=1e-6), k
