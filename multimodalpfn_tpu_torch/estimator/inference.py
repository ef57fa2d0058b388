"""Inference engines: how fit/predict caches work and how members execute.

Reference semantics: `mmpfn/models/mmpfn/inference.py:27-513` (OnDemand /
CachePreprocessing / CacheKV). As in the JAX package
(`multimodalpfn_tpu/estimator/inference.py`), members whose preprocessed widths
match are stacked on the batch axis and run as one forward. Members of
different widths either run as separate groups or are zero-padded to the
widest and run as one masked group (cross-width batching), whichever a cost
rule measured on the H100 predicts to be faster (`_plan_groups`).

A predict splits into `dispatch_outputs`, which transforms the test rows and
enqueues the device work without waiting for it, and `finalize_outputs`,
which copies every group's logits to the host at once. A request stream
(`MMPFNClassifier.predict_proba_many`) dispatches request N+1 before it
finalizes request N, so host work overlaps device work. Every upload of a
predict goes through pinned memory without blocking (`_to_device`), so the
copy of the logits is the only point where the host waits for the card.

Each phase of a predict is a span (`utils.profiling.span`, named
``mmpfn.preprocess.*``, ``mmpfn.forward``), and each point where the host
waits for the card is a ``mmpfn.sync.<site>`` span of its own.
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
from multimodalpfn_tpu_torch.models.params import get_subspace_noise
from multimodalpfn_tpu_torch.models.transformer import forward, member_token_valid
from multimodalpfn_tpu_torch.preprocess.ensemble import EnsembleConfig, fit_preprocessing
from multimodalpfn_tpu_torch.utils.memory import memory_budget, split_batch_for_memory
from multimodalpfn_tpu_torch.utils.profiling import span


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
    without blocking the host, so a dispatch does not wait for the card. numpy
    fills the pinned buffer on this thread: ``Tensor.pin_memory`` copies on
    torch's thread pool, whose wake-up held the host for up to 10 ms on the
    H100's host (PERF.md)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.numpy()[...] = a
    return pinned.to(device, non_blocking=True)


def _fetch(pending: list[tuple[list[int], torch.Tensor]], n_members: int, pad_rows: int):
    """Per-member logits of every pending forward, ``pad_rows`` bucket rows
    cut, with one device-to-host copy (one host sync) for all of them."""
    with span("mmpfn.sync.fetch"):
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


# --- cross-width merge: a device-cost rule measured on the H100 -------------
# A group of n members of t tokens is predicted to take
#     _GROUP_OVERHEAD_MS + n · _member_forward_flops(t) / _EFF_TFLOPS
# and members of different widths merge into one padded group when that is
# predicted to be cheaper than their split groups. The constants are a least
# squares fit to ten warm bf16 groups timed by `tools/torch_merge_cost.py` on
# an H100 80GB HBM3 at 700 W (9.067 ms, 115.22 TFLOP/s; PERF.md). There the
# split groups were faster at the flagship widths 39/39/22/22 (120.0 against
# 137.2 ms merged) and the merged group at widths 10/9 on 60 train rows (12.8
# against 21.3 ms), and the rule picks the same. A KV-cache predict runs only
# the test rows, whose FLOPs are a small share of a forward's: the rule then
# merges the flagship widths too, which chip_smoke.py measured faster there
# over its three requests (PERF.md).
_GROUP_OVERHEAD_MS = 9.07
_EFF_TFLOPS = 115.2
# tests force the decision; None = the cost rule decides
_FORCE_MERGE: bool | None = None


def _member_forward_flops(
    t_tokens: int, s_tr: int, s_te: int, emsize: int, nhid: int, nlayers: int,
    cached: bool = False,
) -> float:
    """Matmul FLOPs of one member's inference forward (2·M·N·K per matmul):
    per layer, feature-attention projections and scores, item-attention
    projections and train-self / test-to-train scores, MLP. ``cached``: a
    KV-cache predict, which runs only the test rows, their item attention
    against the cached train keys (q and out projections only). The mixer and
    the decoder are the same in every plan and leave the decision unchanged."""
    e = emsize
    s = s_te if cached else s_tr + s_te  # the rows the layers run
    N = s * t_tokens
    item_scores = s_te * s_tr if cached else s_tr * s_tr + s_te * s_tr
    per_layer = (
        8 * N * e * e  # feature-attention q, k, v, out projections
        + 4 * s * t_tokens * t_tokens * e  # feature-attention scores + PV
        + (4 if cached else 8) * N * e * e  # item-attention projections
        + 4 * t_tokens * item_scores * e  # item scores + PV
        + 4 * N * e * nhid  # MLP
    )
    return float(nlayers * per_layer)


def _est_group_ms(
    n_members: int, t_tokens: int, s_tr: int, s_te: int, cfg: ModelConfig, cached: bool = False
) -> float:
    fl = _member_forward_flops(t_tokens, s_tr, s_te, cfg.emsize, cfg.nhid, cfg.nlayers, cached)
    return _GROUP_OVERHEAD_MS + n_members * fl / (_EFF_TFLOPS * 1e9)


def _merge_width_aux(
    cfg: ModelConfig, widths: Sequence[int], n_img_tokens: int
) -> tuple[np.ndarray, np.ndarray | None, int]:
    """Cross-width batching: members zero-pad their preprocessed features to
    the widest and run one forward, masking their padded feature tokens out
    of feature attention as keys (exact: the softmax runs over the valid keys
    only; the padded tokens' own rows are computed and never read). Zero
    columns pass the on-device encoder as zeros: a constant column is zeroed,
    the NaN, outlier and normalization statistics of an all-zero column are 0,
    and the variance rescale counts only non-constant columns.

    Returns (tab_valid ``(b, g_max)`` bool, feat_pos_noise ``(b, t_x, k)``
    float32 or None, the widest width). The noise tables hold each member's
    own draws (the CPU generator's draws are not prefix-stable across token
    counts) at the padded layout's slots: features at ``[0, g_i)``, image
    tokens at ``[g_max, g_max + n_img)``."""
    fpg = cfg.features_per_group
    wmax = max(widths)
    g_max = -(-wmax // fpg)
    b = len(widths)
    tab_valid = np.zeros((b, g_max), bool)
    for i, w in enumerate(widths):
        tab_valid[i, : -(-w // fpg)] = True
    noise = None
    if cfg.feature_positional_embedding == "subspace":
        k = cfg.emsize // 4
        noise = np.zeros((b, g_max + n_img_tokens, k), np.float32)
        for i, w in enumerate(widths):
            gi = -(-w // fpg)
            nat = get_subspace_noise(cfg.model_seed, gi + n_img_tokens, k).numpy()
            noise[i, :gi] = nat[:gi]
            if n_img_tokens:
                noise[i, g_max:] = nat[gi:]
    return tab_valid, noise, wmax


def _pad_width(a: np.ndarray, wmax: int) -> np.ndarray:
    """``a`` ``(rows, w)`` as float32, zero-padded to ``wmax`` columns."""
    if a.shape[1] == wmax:
        return np.asarray(a, dtype=np.float32)
    out = np.zeros((a.shape[0], wmax), np.float32)
    out[:, : a.shape[1]] = a
    return out


def _plan_groups(
    groups: dict[tuple, list[int]], cfg: ModelConfig, n_img_tokens: int, n_test: int,
    cached: bool = False,
) -> list[tuple[list[int], int, np.ndarray | None, np.ndarray | None]]:
    """Merge the width groups of one train length into one padded, masked
    group where the cost rule (`_est_group_ms`; ``cached``: of a KV-cache
    predict) predicts the merged forward to be cheaper than the split ones.
    Returns ``[(idxs, width, tab_valid, noise)]``: width -1 is image-only,
    tab_valid None a group of one width."""
    plans: list[tuple[list[int], int, Any, Any]] = []
    by_sep: dict[int, list[tuple[int, list[int]]]] = {}
    for (width, sep), idxs in groups.items():
        if width < 0:
            plans.append((idxs, -1, None, None))
        else:
            by_sep.setdefault(sep, []).append((width, idxs))
    fpg = cfg.features_per_group

    def tokens(w: int) -> int:
        return -(-w // fpg) + n_img_tokens + 1

    for sep, wgroups in by_sep.items():
        widths_flat: list[int] = []
        idxs_flat: list[int] = []
        for w, idxs in wgroups:
            widths_flat += [w] * len(idxs)
            idxs_flat += idxs
        merge = _FORCE_MERGE
        if merge is None and len(wgroups) > 1:
            est_merged = _est_group_ms(
                len(widths_flat), tokens(max(widths_flat)), sep, n_test, cfg, cached
            )
            est_split = sum(
                _est_group_ms(len(idxs), tokens(w), sep, n_test, cfg, cached) for w, idxs in wgroups
            )
            merge = est_merged < est_split
        if len(wgroups) == 1 or not merge:
            plans.extend((idxs, w, None, None) for w, idxs in wgroups)
            continue
        tab_valid, noise, wmax = _merge_width_aux(cfg, widths_flat, n_img_tokens)
        plans.append((idxs_flat, wmax, tab_valid, noise))
    return plans


def _width_groups(members: Sequence[_Member], widths: Sequence[int]) -> dict[tuple, list[int]]:
    """Member indices by (feature width, train length); width -1 image-only."""
    groups: dict[tuple, list[int]] = {}
    for i, (m, w) in enumerate(zip(members, widths)):
        groups.setdefault((w, len(m.y_train)), []).append(i)
    return groups


def _train_side(
    members: Sequence[_Member], idxs: Sequence[int], width: int, noise: np.ndarray | None,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """A planned group's train side on ``device``, uploaded without blocking:
    its members' ``y_train`` ``(b, sep)``, their train rows padded to the
    group's width ``(b, sep, width)`` (None image-only) and a merged group's
    noise tables (None otherwise)."""
    ys = _to_device(np.stack([members[i].y_train.astype(np.float32) for i in idxs]), device)
    xs = None
    if width >= 0:
        xs = _to_device(np.stack([_pad_width(members[i].X_train, width) for i in idxs]), device)
    return ys, xs, None if noise is None else _to_device(noise, device)


def _group_and_run(
    params: dict,
    cfg: ModelConfig,
    members: Sequence[_Member],
    X: np.ndarray | None,
    image_train: torch.Tensor | None,
    image_test: np.ndarray | None,
    *,
    autocast: bool,
    device: torch.device,
    use_kernels: bool | None = None,
    train_sides: dict | None = None,
) -> list[np.ndarray]:
    """Stack members into batched forwards, one per planned group
    (`_plan_groups`); return per-member logits.

    The groups are planned from the members' fitted widths. Then each group in
    turn, narrowest first, transforms its members' test rows ``X``, stacks and
    uploads them and enqueues its forward, so the host transforms group k + 1
    while the card runs group k. Every upload goes through pinned memory
    without blocking (`_to_device`): the one host sync is the fetch.
    ``train_sides`` keeps each group's train side (`_train_side`) on the device
    from one call to the next for members that do not change (a fitted
    engine's); None uploads it every call. ``use_kernels`` (None = on a CUDA
    device) runs the item-major kernel path."""
    run_cfg, kernels = _run_config(cfg, autocast, device, use_kernels)
    # asked once, before any work is queued: while the card runs, CUDA's
    # free-memory query held the host for up to 47 ms (PERF.md)
    budget = memory_budget(device)

    n_test = len(image_test) if X is None else len(X)
    pad_rows = _bucket_test_rows(n_test) - n_test
    image_full = None
    if image_train is not None and image_test is not None:
        with span("mmpfn.preprocess.stack"):
            img_te = _repeat_last_pad(np.asarray(image_test, dtype=np.float32), pad_rows)
        # shared by the members
        image_full = torch.cat([image_train, _to_device(img_te, device)], dim=0)[None]

    n_img_tokens = (
        0 if image_full is None else _mixer_token_count(cfg.mixer, image_full.shape[-2])
    )
    widths = [-1 if m.X_train is None else m.X_train.shape[1] for m in members]
    groups = _width_groups(members, widths)
    # narrowest first: the card idles until the first forward is enqueued, and a
    # group's host work before it (transform, stack, upload) grows with its width
    plans = sorted(_plan_groups(groups, cfg, n_img_tokens, n_test + pad_rows), key=lambda p: p[1])

    pending: list[tuple[list[int], torch.Tensor]] = []
    for idxs, width, tab_valid, noise in plans:
        sep = len(members[idxs[0]].y_train)
        key = (tuple(idxs), width, n_img_tokens)
        side = None if train_sides is None else train_sides.get(key)
        if side is None:
            with span("mmpfn.preprocess.stack"):
                side = _train_side(members, idxs, width, noise, device)
            if train_sides is not None:
                train_sides[key] = side
        ys, xs, noise = side
        if xs is not None:
            with span("mmpfn.preprocess.transform"):
                X_tests = [members[i].preprocessor.transform(X).X for i in idxs]
            with span("mmpfn.preprocess.stack"):
                a = np.stack([_pad_width(_repeat_last_pad(Xt, pad_rows), width) for Xt in X_tests])
            xs = torch.cat([xs, _to_device(a, device)], dim=1)
        total_len = xs.shape[1] if xs is not None else image_full.shape[1]
        n_tokens = (0 if width < 0 else -(-width // cfg.features_per_group)) + n_img_tokens
        for chunk in split_batch_for_memory(
            len(idxs),
            run_cfg,
            seq_len=total_len,
            n_feature_tokens=n_tokens,
            device=device,
            kernels=kernels,
            budget=budget,
        ):
            sl = slice(chunk.start, chunk.stop)
            with span("mmpfn.forward"):
                logits = forward(
                    params,
                    run_cfg,
                    None if xs is None else xs[sl],
                    ys[sl],
                    image_full,
                    single_eval_pos=sep,
                    # the mask stays on the host: K6a checks it there, no sync
                    tab_valid=None if tab_valid is None else torch.from_numpy(tab_valid[sl]),
                    feat_pos_noise=None if noise is None else noise[sl],
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
            self._image_train_dev = _to_device(
                np.asarray(self.image_train, dtype=np.float32), self.device
            )
        return self._image_train_dev

    def _run(self, members, X, image_test, train_sides=None):
        outs = _group_and_run(
            self.params,
            self.cfg,
            members,
            X,
            self._image_train_device(),
            image_test,
            autocast=self.autocast,
            device=self.device,
            use_kernels=self.use_kernels,
            train_sides=train_sides,
        )
        return [(o, m.config) for o, m in zip(outs, members)]


@dataclass
class InferenceEngineCachePreprocessing(InferenceEngine):
    """Fit-time: member pipelines fitted once; predict transforms the test rows
    and runs batched forwards (reference `inference.py:204-351`, the only
    multimodal engine there). Its members are fixed at fit, so each planned
    group's train side stays on the device from the first predict on
    (``train_sides``)."""

    train_sides: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def prepare(cls, X_train, y_train, image_train, *, cat_ix, params, cfg,
                ensemble_configs, rng, autocast, device):
        with span("mmpfn.fit.preprocess"):
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
        return self._run(self.members, X, image_test, self.train_sides)


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
        with span("mmpfn.fit.preprocess"):
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
        groups = _width_groups(
            self.members, [-1 if m.X_train is None else m.X_train.shape[1] for m in self.members]
        )
        # the predict size is unknown when the cache is primed: the plan takes
        # the bucket floor (JAX package `estimator/inference.py:622-625`) and
        # the cost of the predicts, which the plan serves from then on
        plans = _plan_groups(groups, self.cfg, n_img_tokens, TEST_SIZE_BUCKET, cached=True)
        caches = []
        for idxs, width, tab_valid, noise in plans:
            sep = len(self.members[idxs[0]].y_train)
            ys, xs, noise = _train_side(self.members, idxs, width, noise, self.device)
            n_tokens = (0 if width < 0 else -(-width // self.cfg.features_per_group)) + n_img_tokens
            token_valid = None
            if tab_valid is not None:
                # on the host: K6b checks it there, no sync
                token_valid = member_token_valid(torch.from_numpy(tab_valid), n_tokens + 1)
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
                    None if token_valid is None else token_valid[sl],
                    None if noise is None else noise[sl],
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
            with span("mmpfn.cache.prime"):
                self._prime()
        img_dev, n_test = None, None
        if image_test is not None:
            with span("mmpfn.preprocess.stack"):
                a = np.asarray(image_test, dtype=np.float32)
                n_test = len(a)
                a = _repeat_last_pad(a, _bucket_test_rows(n_test) - n_test)
            img_dev = _to_device(a, self.device)[None]  # shared by the members
        with span("mmpfn.preprocess.transform"):
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
                with span("mmpfn.preprocess.stack"):
                    a = np.stack([_pad_width(_repeat_last_pad(X_tests[i], pad_rows), width)
                                  for i in idxs])
                xs = _to_device(a, self.device)
            # the plain path materializes (b, t, h, rows, sep) scores
            for chunk in split_batch_for_memory(
                len(idxs), run_cfg, seq_len=n_rows, kv_len=cache.kv0.shape[-2],
                n_feature_tokens=cache.kv0.shape[2] - 1, device=self.device, kernels=kernels,
            ):
                sl = slice(chunk.start, chunk.stop)
                with span("mmpfn.forward"):
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
        with span("mmpfn.cache.prime"):  # the cache is built at fit time, as in the reference
            engine._prime()
    return engine
