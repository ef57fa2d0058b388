"""PetFinder-shaped data made from a run's ``--seed``: the rows of
too-z/MultiModalPFN's PetFinder image+text run (`datasets/petfinder.py`,
``multimodal_type='all'``; the PetFinder.my Adoption Prediction data,
Kaggle 2019). Every choice below is listed under ``assumed`` in the
configuration that uses it."""

from __future__ import annotations

import numpy as np

# the 14 categorical columns in the loader's order, with about PetFinder's
# distinct values in train.csv
CATEGORIES = {"Breed1": 176, "Breed2": 135, "Color1": 7, "Color2": 7, "Color3": 6, "Dewormed": 3,
              "FurLength": 3, "Gender": 3, "Health": 3, "MaturitySize": 4, "State": 14,
              "Sterilized": 3, "Type": 2, "Vaccinated": 3}
NUMERIC = ("Age", "VideoAmt", "Quantity", "PhotoAmt", "Fee")
# AdoptionSpeed 0-4: about 3, 21, 27, 22 and 28 % of the pets
CLASS_SHARES = (0.027, 0.206, 0.269, 0.217, 0.280)


def _codes(rng: np.random.Generator, y: np.ndarray, n_values: int, k: int) -> np.ndarray:
    """Integer codes with a head-heavy spread (a few values hold most rows)
    whose log-odds shift with the class."""
    logits = -1.2 * np.log1p(np.arange(n_values)) + 0.5 * rng.normal(size=(k, n_values))
    cdf = np.cumsum(np.exp(logits), axis=1)
    cdf /= cdf[:, -1:]
    u = rng.random(len(y))
    return np.minimum((u[:, None] > cdf[y]).sum(axis=1), n_values - 1)


def _numeric(rng: np.random.Generator, y: np.ndarray, k: int) -> np.ndarray:
    """Age in months (median ~3, up to 255), VideoAmt (~96 % none), Quantity
    (~77 % one pet, up to 20), PhotoAmt (1-30: every kept pet has a first
    photo), Fee (~84 % free, up to 3000), each heavy-tailed and shifted by
    the class."""
    n = len(y)
    shift = rng.normal(scale=0.3, size=(k, 5))[y]
    age = np.minimum(np.round(np.exp(1.1 + 1.1 * rng.normal(size=n) + shift[:, 0])), 255)
    video = np.where(rng.random(n) < 0.04, rng.geometric(0.5, n), 0)
    quantity = np.where(rng.random(n) < 0.23 * np.exp(shift[:, 2]), 1 + rng.geometric(0.4, n), 1)
    photo = np.minimum(rng.geometric(np.clip(0.26 * np.exp(-shift[:, 3]), 0.05, 0.9)), 30)
    fee = np.where(rng.random(n) < 0.16, np.round(np.exp(4.5 + rng.normal(size=n) + shift[:, 4])), 0)
    return np.column_stack([age, np.minimum(video, 8), np.minimum(quantity, 20), photo,
                            np.minimum(fee, 3000)]).astype(np.float64)


def petfinder_like(seed: int, data: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """X (n, 19) float64: the 14 category codes, then Age, VideoAmt,
    Quantity, PhotoAmt, Fee; the embeddings (n, 2, 768) float32, a DINOv2
    CLS token of the first photo and an ELECTRA CLS token of the
    description, each carrying the class; the AdoptionSpeed codes (n,)."""
    rng = np.random.default_rng([int(seed), 7])
    n, k = data["rows"], data["classes"]
    shares = np.asarray(CLASS_SHARES[:k])
    y = rng.choice(k, size=n, p=shares / shares.sum())
    cats = np.column_stack([_codes(rng, y, m, k) for m in CATEGORIES.values()])
    X = np.column_stack([cats.astype(np.float64), _numeric(rng, y, k)])
    dim, tokens = data["image_dim"], data["image_tokens"]
    emb = np.empty((n, tokens, dim), np.float32)
    for t in range(tokens):  # one class direction a modality
        dirs = rng.normal(size=(k, dim)).astype(np.float32)
        emb[:, t] = dirs[y] + 0.9 * rng.standard_normal(size=(n, dim), dtype=np.float32)
    return X, emb, y
