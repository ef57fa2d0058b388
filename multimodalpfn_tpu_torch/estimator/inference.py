"""Inference engines: how fit/predict caches work and how members execute.

Reference semantics: `mmpfn/models/mmpfn/inference.py:27-513` (OnDemand /
CachePreprocessing / CacheKV). As in the JAX package
(`multimodalpfn_tpu/estimator/inference.py`), members whose preprocessed widths
match are stacked on the batch axis and run as one forward. Members of
different widths run as separate groups (the JAX package's cross-width merge
and its cost model were calibrated on a TPU and are not carried over).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Literal, Sequence

import numpy as np
import torch

from multimodalpfn_tpu_torch.models.config import ModelConfig
from multimodalpfn_tpu_torch.models.transformer import forward
from multimodalpfn_tpu_torch.preprocess.ensemble import EnsembleConfig, fit_preprocessing
from multimodalpfn_tpu_torch.utils.memory import split_batch_for_memory


@dataclass
class _Member:
    config: EnsembleConfig
    preprocessor: Any  # SequentialFeatureTransformer | None (image-only)
    X_train: np.ndarray | None
    y_train: np.ndarray
    cat_ix: list[int] | None


TEST_SIZE_BUCKET = 128


def _bucket_test_rows(n_test: int, bucket: int = TEST_SIZE_BUCKET) -> int:
    """Round the test-row count up to a bucket so repeated predicts with varying
    test sizes share shapes. Padding rows are copies of an existing row, which
    cannot change any train-fitted or full-sequence encoder statistic
    (constant-column masks see a duplicate value), and test rows never attend
    to each other — so outputs for real rows are unchanged."""
    return max(bucket, -(-n_test // bucket) * bucket)


def _repeat_last_pad(a: np.ndarray, pad: int) -> np.ndarray:
    """Append `pad` copies of the last row (the bucket-padding rule)."""
    if not pad:
        return a
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])


def _mixer_token_count(mx, n_img_patches: int) -> int:
    """Token count the mixer emits: MGM+CAP pools to cap_heads queries; MoE
    emits one token per expert (= mgm_heads); plain MGM emits mgm_heads per
    image patch."""
    if mx.mixer_type == "none":
        return 0
    if mx.mixer_type == "MGM+CAP":
        return mx.cap_heads
    if mx.mixer_type == "MoE":
        return mx.mgm_heads
    return mx.mgm_heads * n_img_patches


def _group_and_run(
    params: dict,
    cfg: ModelConfig,
    members: Sequence[_Member],
    X_tests: Sequence[np.ndarray | None],
    image_train: torch.Tensor | None,
    image_test: np.ndarray | None,
    *,
    autocast: bool,
    device: torch.device,
    use_kernels: bool | None = None,
) -> list[np.ndarray]:
    """Stack same-width members into batched forwards; return per-member logits.

    ``use_kernels`` (None = on a CUDA device) runs the item-major kernel path."""
    kernels = device.type == "cuda" if use_kernels is None else use_kernels
    run_cfg = dataclasses.replace(
        cfg,
        compute_dtype="bfloat16" if autocast else "float32",
        use_flash=kernels,
        fused_ops=kernels,
    )

    n_test = None
    if image_test is not None:
        n_test = len(image_test)
    for Xt in X_tests:
        if Xt is not None:
            n_test = len(Xt)
            break
    pad_rows = _bucket_test_rows(n_test) - n_test
    X_tests = [None if Xt is None else _repeat_last_pad(Xt, pad_rows) for Xt in X_tests]

    image_full = None
    if image_train is not None and image_test is not None:
        img_te = torch.from_numpy(
            _repeat_last_pad(np.asarray(image_test, dtype=np.float32), pad_rows)
        ).to(device)
        image_full = torch.cat([image_train, img_te], dim=0)[None]  # shared by members

    groups: dict[tuple, list[int]] = {}
    for i, (m, Xt) in enumerate(zip(members, X_tests)):
        width = -1 if Xt is None else Xt.shape[1]
        groups.setdefault((width, len(m.y_train)), []).append(i)
    n_img_tokens = (
        0 if image_full is None else _mixer_token_count(cfg.mixer, image_full.shape[-2])
    )

    pending: list[tuple[list[int], torch.Tensor]] = []
    for (width, sep), idxs in groups.items():
        ys = torch.from_numpy(
            np.stack([members[i].y_train.astype(np.float32) for i in idxs])
        ).to(device)
        xs = None
        if width >= 0:
            xs = torch.from_numpy(
                np.stack(
                    [
                        np.concatenate(
                            [members[i].X_train, X_tests[i]], axis=0, dtype=np.float32
                        )
                        for i in idxs
                    ]
                )
            ).to(device)
        total_len = xs.shape[1] if xs is not None else image_full.shape[1]
        n_tokens = (0 if width < 0 else -(-width // cfg.features_per_group)) + n_img_tokens
        for chunk in split_batch_for_memory(
            len(idxs),
            run_cfg,
            seq_len=total_len,
            n_feature_tokens=n_tokens,
            device=device,
            kernels=kernels,
        ):
            sl = slice(chunk.start, chunk.stop)
            logits = forward(
                params,
                run_cfg,
                None if xs is None else xs[sl],
                ys[sl],
                image_full,
                single_eval_pos=sep,
            )
            pending.append((idxs[sl], logits))
    # one host sync for every group
    outputs: list[np.ndarray | None] = [None] * len(members)
    for chunk_idxs, logits in pending:
        logits = logits.cpu().numpy()
        if pad_rows:
            logits = logits[:, :-pad_rows]
        for j, i in enumerate(chunk_idxs):
            outputs[i] = logits[j]
    return outputs  # type: ignore[return-value]


@dataclass
class InferenceEngine:
    """Base: holds the model params/config and fitted members.

    ``use_kernels`` (None = on a CUDA device) is passed to `_group_and_run`;
    setting it to False runs the plain path, which is how the kernel path is
    checked end to end on the card."""

    params: dict
    cfg: ModelConfig
    members: list[_Member]
    image_train: np.ndarray | None
    autocast: bool
    device: torch.device
    use_kernels: bool | None = None

    def iter_outputs(
        self, X: np.ndarray | None, image_test: np.ndarray | None
    ) -> list[tuple[np.ndarray, EnsembleConfig]]:
        raise NotImplementedError

    def _image_train_device(self) -> torch.Tensor | None:
        """The train-side image on the device, uploaded once per engine."""
        if self.image_train is None:
            return None
        if not hasattr(self, "_image_train_dev"):
            self._image_train_dev = torch.from_numpy(
                np.asarray(self.image_train, dtype=np.float32)
            ).to(self.device)
        return self._image_train_dev

    def _run(self, members, X, image_test):
        X_tests = [
            None if m.X_train is None else m.preprocessor.transform(X).X for m in members
        ]
        outs = _group_and_run(
            self.params,
            self.cfg,
            members,
            X_tests,
            self._image_train_device(),
            image_test,
            autocast=self.autocast,
            device=self.device,
            use_kernels=self.use_kernels,
        )
        return [(o, m.config) for o, m in zip(outs, members)]


@dataclass
class InferenceEngineCachePreprocessing(InferenceEngine):
    """Fit-time: member pipelines fitted once; predict transforms the test rows
    and runs batched forwards (reference `inference.py:204-351`, the only
    multimodal engine there)."""

    @classmethod
    def prepare(cls, X_train, y_train, image_train, *, cat_ix, params, cfg,
                ensemble_configs, rng, autocast, device):
        fitted = fit_preprocessing(
            ensemble_configs, X_train, y_train, random_state=rng, cat_ix=cat_ix
        )
        return cls(
            params=params,
            cfg=cfg,
            members=[_Member(*row) for row in fitted],
            image_train=image_train,
            autocast=autocast,
            device=device,
        )

    def iter_outputs(self, X, image_test):
        return self._run(self.members, X, image_test)


@dataclass
class InferenceEngineOnDemand(InferenceEngine):
    """Refit preprocessing on every predict (lowest memory,
    reference `inference.py:79-201`)."""

    X_train: np.ndarray | None = None
    y_train: np.ndarray | None = None
    ensemble_configs: Sequence[EnsembleConfig] = ()
    cat_ix: list[int] | None = None
    static_seed: int = 0

    @classmethod
    def prepare(cls, X_train, y_train, image_train, *, cat_ix, params, cfg,
                ensemble_configs, rng, autocast, device):
        return cls(
            params=params,
            cfg=cfg,
            members=[],
            image_train=image_train,
            autocast=autocast,
            device=device,
            X_train=X_train,
            y_train=y_train,
            ensemble_configs=ensemble_configs,
            cat_ix=cat_ix,
            static_seed=int(rng.integers(0, 2**31)),
        )

    def iter_outputs(self, X, image_test):
        fitted = fit_preprocessing(
            self.ensemble_configs,
            self.X_train,
            self.y_train,
            random_state=np.random.default_rng(self.static_seed),
            cat_ix=self.cat_ix,
        )
        return self._run([_Member(*row) for row in fitted], X, image_test)


def create_inference_engine(
    *,
    X_train,
    y_train,
    image_train,
    params,
    cfg,
    ensemble_configs,
    cat_ix,
    fit_mode: Literal["low_memory", "fit_preprocessors", "fit_with_cache"],
    rng,
    autocast: bool,
    device: torch.device,
) -> InferenceEngine:
    """Reference `base.py:168-257` dispatch."""
    if fit_mode == "low_memory":
        engine_cls = InferenceEngineOnDemand
    elif fit_mode == "fit_preprocessors":
        engine_cls = InferenceEngineCachePreprocessing
    elif fit_mode == "fit_with_cache":
        raise NotImplementedError(
            "fit_mode='fit_with_cache' (the KV-cache engine) is not ported yet"
        )
    else:
        raise ValueError(f"Invalid fit_mode: {fit_mode}")
    return engine_cls.prepare(
        X_train,
        y_train,
        image_train,
        cat_ix=cat_ix,
        params=params,
        cfg=cfg,
        ensemble_configs=ensemble_configs,
        rng=rng,
        autocast=autocast,
        device=device,
    )
