"""The reference of one run of a batched fine-tune sweep
(too-z/MultiModalPFN ``run.py``'s grid of (mgm_heads, cap_heads) cells,
several seeds a cell, run as one sweep): the run's own 80/20 split of a
permutation drawn from its seed, its episodes from the fold stream seeded
4213 + its seed, its dropout drawn from a generator seeded with its seed,
and its mixer at its cell's own head count, unpadded. The steps are those
of `train.fine_tune_steps`."""

from __future__ import annotations

import contextlib
import functools

import numpy as np

from portbench.reference import train
from portbench.reference.episodes import RANDOM_SEED, EpisodeSampler


def run_split(n: int, seed: int, val_fraction: float = 0.2) -> tuple[np.ndarray, np.ndarray]:
    """The run's train and validation rows, in the permutation's order."""
    perm = np.random.default_rng(int(seed)).permutation(n)
    n_val = int(round(n * val_fraction))
    return perm[n_val:], perm[:n_val]


def run_data(X, image, y, seed: int) -> dict:
    tr, va = run_split(len(y), seed)
    return {"train": (X[tr], image[tr], np.asarray(y[tr], np.float32)),
            "val": (X[va], image[va], np.asarray(y[va], np.float32))}


@contextlib.contextmanager
def _episodes_seeded(seed: int):
    """`train.fine_tune_steps` draws its episodes from the fold stream
    seeded ``seed``."""
    sampler = train.EpisodeSampler
    train.EpisodeSampler = functools.partial(EpisodeSampler, seed=seed)
    try:
        yield
    finally:
        train.EpisodeSampler = sampler


def fine_tune_steps(weights: dict, arch: dict, data: dict, *, seed: int, lr: float, n_steps: int,
                    device, precision: str = "float32") -> dict:
    """`train.fine_tune_steps` for the run of seed ``seed``: ``weights`` hold
    the run's own mixer, ``arch`` its head count."""
    with _episodes_seeded(RANDOM_SEED + int(seed)):
        return train.fine_tune_steps(weights, arch, data, seed=seed, lr=lr, n_steps=n_steps,
                                     device=device, precision=precision)
