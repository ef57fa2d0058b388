"""A fitted ``fit_preprocessors`` request: the groups are planned from the
members' fitted widths, each group's test rows are transformed, uploaded and
its forward enqueued in turn, and the train side of every group stays on the
device from the first request on (`estimator/inference.py`).

Against the order a request had before, every member's test rows
transformed, then each group run with its whole train side uploaded: the
same member logits bit for bit, for the classifier and the regressor, on
split and merged plans, on the first request and on the next.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import multimodalpfn_tpu_torch.estimator.inference as inf
from multimodalpfn_tpu_torch import MMPFNClassifier, MMPFNRegressor
from multimodalpfn_tpu_torch.datasets.synthetic import toy_multimodal_classification
from multimodalpfn_tpu_torch.estimator.data_utils import validate_X_predict
from tests.test_torch_classifier import small_ckpt  # noqa: F401
from tests.test_torch_regressor import _write_regression_ckpt


@pytest.fixture(scope="module")
def reg_ckpt(tmp_path_factory):
    return _write_regression_ckpt(tmp_path_factory.mktemp("reg") / "small_reg.ckpt")


def _fitted(kind: str, small_ckpt, reg_ckpt):
    """Four members of two widths (the default preprocessing on 7 features),
    float32 on the CPU; the fitted estimator and a request."""
    X, img, y = toy_multimodal_classification(n=110, n_features=7, n_classes=3, emb_dim=64, seed=3)
    kw = dict(mgm_heads=2, cap_heads=4, n_estimators=4, random_state=0, device="cpu")
    if kind == "classifier":
        est = MMPFNClassifier(model_path=str(small_ckpt), **kw)
    else:
        y = y + 0.1 * np.random.default_rng(3).standard_normal(len(y))
        est = MMPFNRegressor(model_path=str(reg_ckpt), **kw)
    est.fit(X[:80], img[:80], y[:80])
    assert len({m.X_train.shape[1] for m in est.executor_.members}) == 2
    return est, est._encode_X(validate_X_predict(X[80:], est), fit=False), img[80:]


def _before(engine, X, img) -> list[np.ndarray]:
    """Every member's test rows transformed first, then the groups run, each
    uploading its train side."""
    done = [m if m.X_train is None else dataclasses.replace(m, preprocessor=SimpleNamespace(
        transform=lambda _, Xt=m.preprocessor.transform(X).X: SimpleNamespace(X=Xt)))
        for m in engine.members]
    return inf._group_and_run(engine.params, engine.cfg, done, X, engine._image_train_device(), img,
                              autocast=engine.autocast, device=engine.device,
                              use_kernels=engine.use_kernels)


@pytest.mark.parametrize("force_merge", [False, True], ids=["split", "merged"])
@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_fitted_request_answers_the_same_bits(kind, force_merge, small_ckpt, reg_ckpt, monkeypatch):
    monkeypatch.setattr(inf, "_FORCE_MERGE", force_merge)
    est, X, img = _fitted(kind, small_ckpt, reg_ckpt)
    engine = est.executor_
    want = _before(engine, X, img)
    for _ in range(2):  # the first request uploads the train sides, the next reuses them
        got = [o for o, _ in engine.iter_outputs(X, img)]
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)
    assert len(engine.train_sides) == (1 if force_merge else 2)


@pytest.mark.parametrize("force_merge", [False, True], ids=["split", "merged"])
def test_each_group_transforms_before_its_forward(force_merge, small_ckpt, monkeypatch):
    """A group's members transform their test rows after the forward of the
    group before is enqueued, and just before their own."""
    monkeypatch.setattr(inf, "_FORCE_MERGE", force_merge)
    est, X, img = _fitted("classifier", small_ckpt, None)
    engine, events = est.executor_, []
    forward = inf.forward

    def logged_forward(params, cfg, xs, ys, *args, **kwargs):
        events.append(("forward", len(ys)))
        return forward(params, cfg, xs, ys, *args, **kwargs)

    monkeypatch.setattr(inf, "forward", logged_forward)
    for i, m in enumerate(engine.members):
        transform = m.preprocessor.transform
        monkeypatch.setattr(m.preprocessor, "transform",
                            lambda X, i=i, transform=transform: events.append(("transform", i))
                            or transform(X))
    engine.iter_outputs(X, img)
    want = []
    for idxs, *_ in engine.train_sides:
        want += [("transform", i) for i in idxs] + [("forward", len(idxs))]
    assert events == want
    widths = [width for _, width, _ in engine.train_sides]  # narrowest first
    assert widths == sorted(widths) and len(set(widths)) == len(widths)


def test_free_memory_is_asked_once_a_request(small_ckpt, monkeypatch):
    """One query of the device's free memory a request, before the first
    group, whose budget every group's split takes."""
    monkeypatch.setattr(inf, "_FORCE_MERGE", False)
    est, X, img = _fitted("classifier", small_ckpt, None)
    asked, budgets = [], []
    split = inf.split_batch_for_memory
    monkeypatch.setattr(inf, "memory_budget", lambda device: asked.append(device) or 1 << 40)
    monkeypatch.setattr(inf, "split_batch_for_memory",
                        lambda *a, **kw: budgets.append(kw["budget"]) or split(*a, **kw))
    est.executor_.iter_outputs(X, img)
    assert asked == [est.executor_.device] and budgets == [1 << 40, 1 << 40]


def test_next_request_uploads_only_its_test_rows(small_ckpt, monkeypatch):
    """The second request keeps the first's train sides, the very tensors,
    and uploads the test image and each group's test rows alone."""
    est, X, img = _fitted("classifier", small_ckpt, None)
    engine = est.executor_
    engine.iter_outputs(X, img)
    sides = {k: list(v) for k, v in engine.train_sides.items()}
    uploads, built = [], []
    to_device, train_side = inf._to_device, inf._train_side
    monkeypatch.setattr(inf, "_to_device", lambda a, d: uploads.append(a.shape) or to_device(a, d))
    monkeypatch.setattr(inf, "_train_side", lambda *a: built.append(a) or train_side(*a))
    engine.iter_outputs(X, img)
    assert built == []
    assert {k: list(v) for k, v in engine.train_sides.items()} == sides
    assert all(a is b for k in sides for a, b in zip(engine.train_sides[k], sides[k]))
    n_rows = inf._bucket_test_rows(len(X))
    assert uploads == [(n_rows, *img.shape[1:])] + [
        (len(idxs), n_rows, width) for idxs, width, _ in engine.train_sides]


def test_on_demand_engine_keeps_no_train_side(small_ckpt, monkeypatch):
    """``low_memory`` refits its members every request: it keeps no train
    side and uploads its groups whole each time, to the same answers."""
    X, img, y = toy_multimodal_classification(n=110, n_features=7, n_classes=3, emb_dim=64, seed=3)
    clf = MMPFNClassifier(model_path=str(small_ckpt), mgm_heads=2, cap_heads=4, n_estimators=4,
                          random_state=0, device="cpu", fit_mode="low_memory")
    clf.fit(X[:80], img[:80], y[:80])
    kept, run = [], inf._group_and_run
    monkeypatch.setattr(inf, "_group_and_run",
                        lambda *a, **kw: kept.append(kw["train_sides"]) or run(*a, **kw))
    first, second = (clf.predict_proba(X[80:], img[80:]) for _ in range(2))
    assert kept == [None, None] and not hasattr(clf.executor_, "train_sides")
    np.testing.assert_array_equal(first, second)
