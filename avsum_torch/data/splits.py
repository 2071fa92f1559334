"""Deterministic train/test splits.

Fixes the reference's ``create_splits`` (unseeded shuffle + stale ``*.npy``
glob, reference/scripts/create_splits.py:7-15; SURVEY.md §8.6) and
adds the canonical k-fold cross-validation protocol the TVSum/SumMe
literature uses (5 folds; every video appears in exactly one test fold).
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np


def create_split(
    video_ids: Sequence[str],
    train_fraction: float = 0.8,
    seed: int = 0,
) -> Dict[str, List[str]]:
    """Seeded 80/20 split (the reference's shape, made reproducible)."""
    ids = sorted(video_ids)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(ids))
    cut = int(train_fraction * len(ids))
    return {
        "train": [ids[i] for i in order[:cut]],
        "test": [ids[i] for i in order[cut:]],
    }


def create_kfold_splits(
    video_ids: Sequence[str],
    n_folds: int = 5,
    seed: int = 0,
) -> List[Dict[str, List[str]]]:
    """Canonical cross-validation folds; fold i tests on slice i."""
    ids = sorted(video_ids)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(ids))
    folds = np.array_split(order, n_folds)
    out = []
    for i in range(n_folds):
        test = sorted(ids[j] for j in folds[i])
        train = sorted(
            ids[j] for k, fold in enumerate(folds) if k != i for j in fold
        )
        out.append({"train": train, "test": test})
    return out


def save_splits(splits, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(splits, fh, indent=1)


def load_splits(path: str):
    with open(path) as fh:
        return json.load(fh)
