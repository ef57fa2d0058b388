"""Inference engines: how fit/predict caches work and how members execute.

Reference semantics: `mmpfn/models/mmpfn/inference.py:27-513` (OnDemand /
CachePreprocessing / CacheKV). As in the JAX package
(`multimodalpfn_tpu/estimator/inference.py`), members whose preprocessed widths
match are stacked on the batch axis and run as one forward. Members of
different widths run as separate groups (the JAX package's cross-width merge
and its cost model were calibrated on a TPU and are not carried over).

A predict splits into `dispatch_outputs`, which transforms the test rows and
enqueues the device work without waiting for it, and `finalize_outputs`,
which copies every group's logits to the host at once. A request stream
(`MMPFNClassifier.predict_proba_many`) dispatches request N+1 before it
finalizes request N, so host work overlaps device work.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Literal, Sequence

import numpy as np
import torch

from multimodalpfn_tpu_torch.models.cached import (
    TrainsetCache,
    forward_cached,
    prime_cache,
    slice_members,
)
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


def _run_config(
    cfg: ModelConfig, autocast: bool, device: torch.device, use_kernels: bool | None
) -> tuple[ModelConfig, bool]:
    """The model config a forward runs with (bf16 or float32 compute, the
    kernels on or off: ``use_kernels``, None = on a CUDA device) and whether
    the kernels are on."""
    kernels = device.type == "cuda" if use_kernels is None else use_kernels
    run_cfg = dataclasses.replace(
        cfg,
        compute_dtype="bfloat16" if autocast else "float32",
        use_flash=kernels,
        fused_ops=kernels,
    )
    return run_cfg, kernels


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to a CUDA device through pinned memory
    without blocking the host, so a dispatch does not wait for the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _fetch(pending: list[tuple[list[int], torch.Tensor]], n_members: int, pad_rows: int):
    """Per-member logits of every pending forward, ``pad_rows`` bucket rows
    cut, with one device-to-host copy (one host sync) for all of them."""
    flat = torch.cat([lg.reshape(-1) for _, lg in pending]).cpu().numpy()
    outputs: list[np.ndarray | None] = [None] * n_members
    off = 0
    for idxs, lg in pending:
        a = flat[off : off + lg.numel()].reshape(lg.shape)
        off += lg.numel()
        if pad_rows:
            a = a[:, :-pad_rows]
        for j, i in enumerate(idxs):
            outputs[i] = a[j]
    return outputs


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
    run_cfg, kernels = _run_config(cfg, autocast, device, use_kernels)

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
    return _fetch(pending, len(members), pad_rows)  # type: ignore[return-value]


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

    def dispatch_outputs(self, X, image_test):
        """Begin one predict and return a handle for `finalize_outputs`. An
        engine without a device phase to overlap computes everything here."""
        return ("eager", self.iter_outputs(X, image_test))

    def finalize_outputs(self, handle) -> list[tuple[np.ndarray, EnsembleConfig]]:
        """Complete a predict begun by `dispatch_outputs` (the host sync)."""
        return handle[1]

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


@dataclass
class InferenceEngineCacheKV(InferenceEngineCachePreprocessing):
    """fit_with_cache: prime each member group's per-layer train K/V cache at
    fit time; a predict runs only the test rows against it (reference
    `inference.py:354-513`; the JAX package's `InferenceEngineCacheKV`).

    A cache holds values of one run configuration (compute dtype, kernels on
    or off): when ``use_kernels`` changes, the next predict primes again."""

    caches: list[tuple[TrainsetCache, list[int], int]] | None = None
    primed_cfg: ModelConfig | None = None

    def _run_cfg(self) -> tuple[ModelConfig, bool]:
        return _run_config(self.cfg, self.autocast, self.device, self.use_kernels)

    def _prime(self) -> None:
        run_cfg, kernels = self._run_cfg()
        img = self._image_train_device()
        n_img_tokens = 0 if img is None else _mixer_token_count(self.cfg.mixer, img.shape[-2])
        groups: dict[tuple, list[int]] = {}
        for i, m in enumerate(self.members):
            width = -1 if m.X_train is None else m.X_train.shape[1]
            groups.setdefault((width, len(m.y_train)), []).append(i)
        caches = []
        for (width, sep), idxs in groups.items():
            ys = _to_device(np.stack([self.members[i].y_train.astype(np.float32) for i in idxs]),
                            self.device)
            xs = None
            if width >= 0:
                xs = _to_device(
                    np.stack([self.members[i].X_train.astype(np.float32) for i in idxs]),
                    self.device,
                )
            n_tokens = (0 if width < 0 else -(-width // self.cfg.features_per_group)) + n_img_tokens
            # the plain path materializes (b, t, h, sep, sep) scores
            for chunk in split_batch_for_memory(
                len(idxs), run_cfg, seq_len=sep, n_feature_tokens=n_tokens,
                device=self.device, kernels=kernels,
            ):
                sl = slice(chunk.start, chunk.stop)
                cache = prime_cache(
                    self.params,
                    run_cfg,
                    None if xs is None else xs[sl],
                    ys[sl],
                    None if img is None else img[None],  # shared by the members
                )
                caches.append((cache, idxs[sl], width))
        self.caches, self.primed_cfg = caches, run_cfg

    def iter_outputs(self, X, image_test):
        return self.finalize_outputs(self.dispatch_outputs(X, image_test))

    def dispatch_outputs(self, X, image_test):
        """Transform the test rows and enqueue every cache group's forward;
        nothing here waits for the card."""
        run_cfg, kernels = self._run_cfg()
        if run_cfg != self.primed_cfg:
            self._prime()
        img_dev, n_test = None, None
        if image_test is not None:
            a = np.asarray(image_test, dtype=np.float32)
            n_test = len(a)
            img_dev = _to_device(_repeat_last_pad(a, _bucket_test_rows(n_test) - n_test),
                                 self.device)[None]  # shared by the members
        X_tests = [
            None if m.X_train is None else m.preprocessor.transform(X).X for m in self.members
        ]
        if n_test is None:
            n_test = len(next(Xt for Xt in X_tests if Xt is not None))
        n_rows = _bucket_test_rows(n_test)
        pad_rows = n_rows - n_test
        pending: list[tuple[list[int], torch.Tensor]] = []
        for cache, idxs, width in self.caches:
            xs = None
            if width >= 0:
                xs = _to_device(
                    np.stack([_repeat_last_pad(X_tests[i], pad_rows).astype(np.float32)
                              for i in idxs]),
                    self.device,
                )
            # the plain path materializes (b, t, h, rows, sep) scores
            for chunk in split_batch_for_memory(
                len(idxs), run_cfg, seq_len=n_rows, kv_len=cache.kv0.shape[-2],
                n_feature_tokens=cache.kv0.shape[2] - 1, device=self.device, kernels=kernels,
            ):
                sl = slice(chunk.start, chunk.stop)
                logits = forward_cached(
                    self.params, run_cfg, slice_members(cache, sl),
                    None if xs is None else xs[sl], img_dev,
                )
                pending.append((idxs[sl], logits))
        return ("kv", pending, pad_rows)

    def finalize_outputs(self, handle):
        _, pending, pad_rows = handle
        outputs = _fetch(pending, len(self.members), pad_rows)
        return [(o, m.config) for o, m in zip(outputs, self.members)]


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
        engine_cls = InferenceEngineCacheKV
    else:
        raise ValueError(f"Invalid fit_mode: {fit_mode}")
    engine = engine_cls.prepare(
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
    if isinstance(engine, InferenceEngineCacheKV):
        engine._prime()  # the cache is built at fit time, as in the reference
    return engine
