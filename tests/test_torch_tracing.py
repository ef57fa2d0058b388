"""The port's spans (`multimodalpfn_tpu_torch.utils.profiling.span`): under a
CPU `torch.profiler`, a predict of each serving engine and one fine-tune
iteration emit the ``mmpfn.*`` spans nested and ordered as the layers run,
and a pipelined stream dispatches a request before it finalizes the one
ahead; without a profiler no span reaches ``record_function``. That every host sync is one ``mmpfn.sync.*``
span is checked on a card (`tests/test_torch_cuda.py`, with
`tools/torch_sync_audit.py`).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multimodalpfn_tpu_torch import MMPFNClassifier
from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig
from multimodalpfn_tpu_torch.utils import profiling
from tests.test_torch_classifier import _data, _kwargs, small_ckpt  # noqa: F401
from tests.test_torch_finetune import tiny_ckpt  # noqa: F401

ENGINES = ["fit_preprocessors", "fit_with_cache"]


def _fitted(ckpt, fit_mode: str, device: str = "cpu") -> tuple[MMPFNClassifier, np.ndarray, np.ndarray]:
    X_tr, img_tr, y_tr, X_te, img_te = _data()
    clf = MMPFNClassifier(model_path=str(ckpt), mgm_heads=2, cap_heads=4, device=device,
                          fit_mode=fit_mode, **_kwargs(PreprocessorConfig))
    clf.fit(X_tr, img_tr, y_tr)
    return clf, X_te, img_te


def _spans(fn) -> list[tuple[str, float, float]]:
    """``fn()`` under a CPU profiler: its ``mmpfn.*`` spans as (name, start,
    end), by start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith("mmpfn.")]
    return sorted(out, key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(spans, name: str) -> list:
    return [s for s in spans if s[0] == name]


def test_span_without_a_profiler_never_calls_record_function(small_ckpt, monkeypatch):
    clf, X_te, img_te = _fitted(small_ckpt, "fit_with_cache")

    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("mmpfn.test"):
        pass
    assert clf.predict_proba_many([X_te, X_te], [img_te, img_te])[0].shape == (len(X_te), 3)


@pytest.mark.parametrize("fit_mode", ENGINES)
def test_predict_spans_nest_in_the_request(small_ckpt, fit_mode):
    clf, X_te, img_te = _fitted(small_ckpt, fit_mode)
    spans = _spans(lambda: clf.predict_proba(X_te, img_te))
    (dispatch,), (finalize,) = _named(spans, "mmpfn.predict.dispatch"), _named(spans, "mmpfn.predict.finalize")
    (fetch,) = _named(spans, "mmpfn.sync.fetch")
    forwards = _named(spans, "mmpfn.forward")
    prep = [s for s in spans if s[0].startswith("mmpfn.preprocess.")]
    assert {s[0] for s in prep} >= {"mmpfn.preprocess.validate", "mmpfn.preprocess.transform",
                                     "mmpfn.preprocess.stack"}
    assert forwards and all(_inside(s, dispatch) for s in prep + forwards)
    # the preprocessing spans are leaves: none holds another
    assert not any(_inside(a, b) for a in prep for b in prep if a is not b)
    # dispatch, its preprocessing and forwards, then the fetch and finalize
    assert dispatch[1] <= prep[0][1] and prep[0][2] <= forwards[0][1] <= forwards[-1][2] <= fetch[1]
    assert dispatch[2] <= finalize[1]
    # the fetch is the eager engines' last act of the dispatch, and the
    # cached engine's first of the finalize
    assert _inside(fetch, dispatch if fit_mode == "fit_preprocessors" else finalize)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("fit_mode", ENGINES)
def test_the_mixer_is_one_span_in_each_forward(small_ckpt, monkeypatch, fit_mode, split):
    """Each ``mmpfn.forward`` holds exactly one ``mmpfn.forward.mixer``, in
    both forwards; with ``split`` the memory budget holds one member, so a
    request's members run as several forwards, each a span of its own."""
    from multimodalpfn_tpu_torch.estimator import inference
    from multimodalpfn_tpu_torch.utils import memory

    clf, X_te, img_te = _fitted(small_ckpt, fit_mode)
    if split:
        for mod in (inference, memory):
            monkeypatch.setattr(mod, "memory_budget", lambda device: 1)
    spans = _spans(lambda: clf.predict_proba(X_te, img_te))
    forwards, mixers = _named(spans, "mmpfn.forward"), _named(spans, "mmpfn.forward.mixer")
    assert forwards and (not split or len(forwards) == clf.n_estimators)
    for f in forwards:
        assert len([m for m in mixers if _inside(m, f)]) == 1
    assert len(mixers) == len(forwards)


def test_predict_many_pipelines_its_requests(small_ckpt):
    clf, X_te, img_te = _fitted(small_ckpt, "fit_with_cache")
    n = 4
    spans = _spans(lambda: clf.predict_proba_many([X_te] * n, [img_te] * n, max_in_flight=2))
    dispatches, finalizes = _named(spans, "mmpfn.predict.dispatch"), _named(spans, "mmpfn.predict.finalize")
    assert len(dispatches) == len(finalizes) == n
    # every request's forwards lie in its dispatch, its fetch in its finalize
    for d in dispatches:
        assert any(_inside(f, d) for f in _named(spans, "mmpfn.forward"))
    for f in finalizes:
        assert len([s for s in _named(spans, "mmpfn.sync.fetch") if _inside(s, f)]) == 1
    # two wait in flight: request 1 is finalized once request 3 is
    # dispatched, request 2 once request 4 is
    order = [s[0].rsplit(".", 1)[1] for s in spans if s in dispatches + finalizes]
    assert order == ["dispatch"] * 3 + ["finalize", "dispatch"] + ["finalize"] * 3


def test_finetune_iteration_spans(tiny_ckpt, tmp_path):
    from multimodalpfn_tpu_torch.datasets.synthetic import toy_classification
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn

    X, y = toy_classification(n=60, n_classes=3, nan_share=0.0, seed=0)

    def one_iteration():
        fine_tune_mmpfn(mixer_type="none", mgm_heads=2, cap_heads=2, features_per_group=1,
                        path_to_base_model=tiny_ckpt, save_path_to_fine_tuned_model=tmp_path / "ft.ckpt",
                        finetuning_config={"max_steps": 1, "learning_rate": 1e-3},
                        X_train=X, y_train=y, random_seed=0, device="cpu", state_checkpoint_every=0)

    spans = _spans(one_iteration)
    (step,) = _named(spans, "mmpfn.train.step")
    parts = [_named(spans, f"mmpfn.train.{p}") for p in ("batch", "forward", "backward", "optimizer")]
    assert [len(p) for p in parts] == [1, 1, 1, 1]
    parts = [p[0] for p in parts]
    assert all(_inside(p, step) for p in parts)
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))  # in that order
    batch, _, _, optimizer = parts
    uploads = _named(spans, "mmpfn.sync.upload")
    assert len([u for u in uploads if _inside(u, batch)]) == 2
    assert [s[0] for s in spans if _inside(s, optimizer) and s[0].startswith("mmpfn.sync.")] == [
        "mmpfn.sync.finite", "mmpfn.sync.clip"]
    # after the step: the loop's two reads, the validation (with its fetch)
    # and the bookkeeping
    (loss,), (gn,) = _named(spans, "mmpfn.sync.loss"), _named(spans, "mmpfn.sync.grad_norm")
    val = [v for v in _named(spans, "mmpfn.train.validation") if v[1] >= step[2]]
    (book,) = _named(spans, "mmpfn.train.bookkeeping")
    assert len(val) == 1 and step[2] <= loss[1] <= gn[1] <= val[0][1] <= book[1]
    assert len([s for s in _named(spans, "mmpfn.sync.validation") if _inside(s, val[0])]) == 1
