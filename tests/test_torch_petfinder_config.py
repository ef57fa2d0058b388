"""MMPFN's PetFinder image+text configuration on the port, against the
benchmark's plain reference of it (`portbench/reference/petfinder.py`), on
the CPU in float32 with seeded random weights at the published widths and
two layers: 19 features two a group (the last group half filled), two
embedding tokens a row (image and text), MGM 32 / CAP 24, preprocessing off
with four members, and more train rows than a lowered
``MAX_NUMBER_OF_SAMPLES`` with ``ignore_pretraining_limits``. The same
shape against the JAX package: the ``petfinder`` case of
`tests/test_torch_forward.py` and `test_petfinder_shaped_classifier_matches_jax`
in `tests/test_torch_options_parity.py`.

Tolerance: both sides compute in float32 and differ only in the order of
their sums (the port's encoder statistics, batched members and fused
einsums against the reference's one member at a time and blocked item
attention), so logits agree to a few float32 roundings of their size over
two layers (measured: at most 3.6e-7 on logits of size 0.4, 3.7e-8 on
probabilities). 1e-4 leaves that room hundreds of times over, and the
reference with its products' operands in float8 e4m3 reads 4.8e-3, 48
times past it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from multimodalpfn_tpu_torch import MMPFNClassifier
from multimodalpfn_tpu_torch.models.loading import load_model
from multimodalpfn_tpu_torch.models.transformer import forward
from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig
from portbench import bench, make, make_petfinder
from portbench.reference import petfinder

TOL = 1e-4
SEED = 2**31 + 4321
N_TRAIN, N_TEST = 150, 40
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def config() -> dict:
    cfg = bench.load_json(bench.ROOT / "portbench/configs/mmpfn-clf-petfinder-mgmcap32x24.json")
    cfg["architecture"]["nlayers"] = 2
    cfg["data"]["rows"] = N_TRAIN + N_TEST
    return cfg


@pytest.fixture(scope="module")
def model(config, tmp_path_factory):
    """The configuration's weights from the seed, float32, and their model
    file."""
    arch = {**config["architecture"], "model_seed": make.model_seed(SEED)}
    weights = make.make_weights(arch, SEED, CPU)
    path = tmp_path_factory.mktemp("petfinder") / "model.npz"
    make.write_npz(path, weights, arch, SEED)
    return arch, weights, path


@pytest.fixture(scope="module")
def data(config):
    X, img, y = make_petfinder.petfinder_like(SEED, config["data"])
    return X, img, y


def _inference_config(max_samples: int = 100) -> dict:
    return {"FINGERPRINT_FEATURE": False, "PREPROCESS_TRANSFORMS": [PreprocessorConfig(name="none")],
            "MAX_NUMBER_OF_SAMPLES": max_samples}


def _classifier(config, path, fit_mode="fit_preprocessors", ignore_limits=True) -> MMPFNClassifier:
    est, mix = config["estimator"], config["architecture"]["mixer"]
    return MMPFNClassifier(
        model_path=str(path), mixer_type=mix["mixer_type"], mgm_heads=mix["mgm_heads"],
        cap_heads=mix["cap_heads"], features_per_group=config["architecture"]["features_per_group"],
        n_estimators=est["n_estimators"], softmax_temperature=est["softmax_temperature"],
        categorical_features_indices=est["categorical_features_indices"],
        ignore_pretraining_limits=ignore_limits, inference_config=_inference_config(),
        fit_mode=fit_mode, random_state=SEED % 2**31, device="cpu", inference_precision="float32")


def _members(config, data) -> petfinder.PlainMembers:
    X, _, y = data
    est = {**config["estimator"], "random_state": SEED % 2**31}
    return petfinder.PlainMembers(X[:N_TRAIN], y[:N_TRAIN], est, est["categorical_features_indices"])


def _rows(data, kind: str) -> np.ndarray:
    """The rows of one forward: as made, with missing values, or with a
    constant column (the grouped encoder's compaction)."""
    X = data[0].astype(np.float32).copy()
    if kind == "missing":
        X[np.random.default_rng(0).random(X.shape) < 0.05] = np.nan
    elif kind == "constant":
        X[:, [3, 16]] = 7.0  # one column of a full group, one of the numeric ones
    return X


@pytest.mark.parametrize("kind", ["plain", "missing", "constant"])
def test_forward_agrees_with_the_reference(model, data, kind):
    """The port's plain float32 forward of one member at fpg 2 (ten groups,
    the last half filled), two embedding tokens, MGM 32 / CAP 24."""
    arch, weights, path = model
    loaded = load_model(path)
    cfg = dataclasses.replace(loaded.config, compute_dtype="float32", use_flash=False, fused_ops=False,
                              remove_outliers=True, remove_outliers_sigma=petfinder.OUTLIER_SIGMA)
    assert cfg.features_per_group == 2 and (cfg.mixer.mgm_heads, cfg.mixer.cap_heads) == (32, 24)
    X, img, y = _rows(data, kind), data[1], data[2].astype(np.float32)
    got = forward(loaded.params, cfg, torch.from_numpy(X)[None], torch.from_numpy(y[:N_TRAIN])[None],
                  torch.from_numpy(img)[None], single_eval_pos=N_TRAIN)[0]
    want = petfinder.forward(weights, arch, torch.from_numpy(X), torch.from_numpy(y[:N_TRAIN]),
                             torch.from_numpy(img))
    assert got.shape == want.shape == (N_TEST, arch["n_out"])
    assert float((got - want).abs().max()) < TOL


@pytest.mark.parametrize("fit_mode", ["fit_preprocessors", "fit_with_cache"])
def test_predict_proba_agrees_with_the_reference(config, model, data, fit_mode):
    """``MMPFNClassifier`` with preprocessing off, four members, the
    categorical columns given, fitted on more rows than its lowered
    pretraining limit, against the reference's ensemble."""
    arch, weights, path = model
    X, img, y = data
    clf = _classifier(config, path, fit_mode)
    with pytest.warns(UserWarning, match="exceeds the maximum"):
        clf.fit(X[:N_TRAIN], img[:N_TRAIN], y[:N_TRAIN])
    got = clf.predict_proba(X[N_TRAIN:], img[N_TRAIN:])
    members = _members(config, data)
    assert members.widths() == [19] * 4
    want = members.predict_proba(weights, arch, img[:N_TRAIN], X[N_TRAIN:], img[N_TRAIN:], CPU)
    assert got.shape == want.shape == (N_TEST, 5)
    assert float(np.abs(got - want).max()) < TOL


def test_the_pretraining_limit_holds_without_the_flag(config, model, data):
    X, img, y = data
    clf = _classifier(config, model[2], ignore_limits=False)
    with pytest.raises(ValueError, match="ignore_pretraining_limits"):
        clf.fit(X[:N_TRAIN], img[:N_TRAIN], y[:N_TRAIN])


def test_the_reference_in_float8_falls_outside_the_tolerance(config, model, data):
    arch, weights, _ = model
    X, img, _ = data
    members = _members(config, data)
    args = (weights, arch, img[:N_TRAIN], X[N_TRAIN:], img[N_TRAIN:], CPU)
    gap = float(np.abs(members.predict_proba(*args, precision="fp8") - members.predict_proba(*args)).max())
    assert gap > TOL


def test_query_blocks_leave_the_item_attention_unchanged(model, data):
    """The reference's item attention in blocks of query rows equals it
    formed whole (`reference/model.py`)."""
    arch, weights, _ = model
    x = torch.randn(N_TRAIN + N_TEST, 6, arch["emsize"], generator=torch.Generator().manual_seed(0))
    w_qkv, w_out = weights["layers/attn_item/w_qkv"][0], weights["layers/attn_item/w_out"][0]
    ar = petfinder.Arith("float32")
    whole = petfinder.model._item_attention(x, w_qkv, w_out, N_TRAIN, ar)
    blocked = petfinder.item_attention(x, w_qkv, w_out, N_TRAIN, ar, query_block=32)
    assert float((whole - blocked).abs().max()) < 1e-5
