"""Leaderboard submission tooling.

Counterpart of :mod:`dfac_tpu.io.submission`: the artifact of reference
``scripts/generate_submission.py:6-50``, a pickled dict ``{student_id,
first_name, last_name, nickname, predictions: DataFrame}`` written to
``<id>-<first>-<last>-<nick>.pkl`` after the prediction DataFrame is
validated (exactly 2 columns, the features' uttid set, float64 scores).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import pandas as pd


def validate_prediction_frame(prediction_df: pd.DataFrame, feature_uttids) -> pd.DataFrame:
    """The checks of reference ``scripts/generate_submission.py:20-36``."""
    if len(prediction_df.columns) != 2:
        raise ValueError("prediction.pkl must have exactly 2 columns")
    if "uttid" not in prediction_df.columns or "predictions" not in prediction_df.columns:
        raise ValueError("prediction.pkl must have 'uttid' and 'predictions' columns")
    if set(feature_uttids) != set(prediction_df["uttid"].values):
        raise ValueError("uttid mismatch between features.pkl and prediction.pkl")
    if not all(isinstance(x, (float, np.floating)) for x in prediction_df["predictions"].values):
        prediction_df = prediction_df.copy()
        prediction_df["predictions"] = prediction_df["predictions"].astype(np.float64)
    return prediction_df


def generate_submission(
    features_path: str,
    prediction_path: str,
    student_id: str,
    first_name: str,
    last_name: str,
    nickname: str,
    output_dir: str = ".",
) -> str:
    features_df = pd.read_pickle(features_path)
    prediction_df = pd.read_pickle(prediction_path)
    if "uttid" not in features_df.columns:
        raise ValueError("features.pkl must have 'uttid' column")

    prediction_df = validate_prediction_frame(prediction_df, features_df["uttid"].values)
    result = {
        "student_id": student_id,
        "first_name": first_name,
        "last_name": last_name,
        "nickname": nickname,
        "predictions": prediction_df,
    }
    out = os.path.join(output_dir, f"{student_id}-{first_name}-{last_name}-{nickname}.pkl")
    with open(out, "wb") as f:
        pickle.dump(result, f)
    return out


def submission_class_counts(path: str, threshold: float = 0.5) -> tuple[int, int]:
    """Class balance of a submission file at a threshold (reference
    ``scripts/pred.py:5-15``): ``(n_class1, n_class0)``."""
    with open(path, "rb") as f:
        sub = pickle.load(f)
    scores = np.asarray(sub["predictions"]["predictions"], dtype=float)
    n1 = int((scores > threshold).sum())
    return n1, len(scores) - n1
