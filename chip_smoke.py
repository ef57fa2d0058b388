#!/usr/bin/env python3
"""On-card proof that the PyTorch/CUDA port (``multimodalpfn_tpu_torch``) runs.

Run from the repository root on a machine with one NVIDIA GPU (H100) and
``nvcc``:

    python3 chip_smoke.py

Phases, each of which must pass:

1. Setup: print the card (``nvidia-smi`` name and power limit), turn TF32 off,
   build the CUDA kernels from ``multimodalpfn_tpu_torch/csrc`` and print the
   build time; write the model every phase serves (the published 192×12
   architecture with MGM+CAP 16/8, random weights from seed 0, output
   projections filled in from seed 1) to ``build/``.
2. Kernel checks: each kernel against its plain PyTorch version at the shapes
   the served paths give it, in float32 and bfloat16, with times of kernel
   and plain version (CUDA events), the least time the card could take for
   the same work (``bound_ms``) and, where one PyTorch call computes the same
   function, that call's time (``library_ms``). K1, K2a, K2b and K3 at the
   ``fit_preprocessors`` shapes (4 members, 1838 train + 460 test rows bucketed
   to 2350, 31 tokens, e = 192, h = 6, d = 32, nhid = 768), K1 also at 48
   tokens; K4 at the KV-cache prime shape (G = 4·31·6, 1838 × 1838) and the
   multiquery predict shape (G = 4·31, 6·512 queries, 1838 keys); K5 at the
   prime shape (4, 1838, 31, 192) and at 48 tokens; the key-masked K6a at
   (4, 48, 2350, 192) and K6b at the merged prime (4·1838, 48, 192) and
   predict (4·512, 48, 192) shapes, with the masks of members 39/39/22/22
   features wide (+ 8 image tokens and the target: 17 keys of the narrow
   members masked).
3. ``fit_preprocessors`` served: ``MMPFNClassifier`` (4 members, the
   classifier's default preprocessing: quantile transform, appended
   originals, global SVD, on numpy/scipy) fits the PAD-UFES-shaped synthetic
   set and answers three ``predict_proba`` requests (460, 128 and 300 test
   rows); the members' widths and the planned groups are printed; the launch
   counters, zeroed just before, show the item-major kernels (K1, or K6a for
   a merged group; K2a, K2b, K3) ran in every layer of every group; then the
   same requests again, warm.
4. Its kernel path against its plain path: float32 ``predict_proba`` (the
   plain path split by the memory estimate).
5. ``fit_with_cache`` served: fit (which primes the KV cache) and the same
   three requests; the counters, zeroed just before the fit, show K4, K5 (or
   K6b) and K3 ran in every layer of the prime and of each request, and no
   item-major kernel ran; then the requests again, warm.
   ``predict_proba_many`` over the three requests equals the sequential
   answers exactly. The largest difference from phase
   3's answers is printed (the two differ by design where the encoder's
   constant-column masks differ, `models/cached.py`).
6. The cached kernel path against the cached plain path: float32
   ``predict_proba``.
7. Forced plans (``estimator.inference._FORCE_MERGE``): the members' widths
   as split groups and as one padded group, in both fit modes, whatever the
   cost rule plans (its own choices are printed). In bf16, with the counters
   zeroed just before the fit: split groups launch K1 (K5 in the prime and
   every request) in every layer and no masked kernel; the merged group K6a
   (K6b) and no unmasked one; warm requests of both plans are timed. In
   float32 the merged answers equal the split ones to 1e-5, and the merged
   kernel path matches the merged plain path to 1e-4.

``--profile`` adds a phase 8: ``torch.profiler`` around one warm request of
each size in both modes, printing wall time, device kernel time, the idle
share and the kernels that took the most device time.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA the script exits
non-zero and prints no result. ``--rehearse`` runs the phases at a tiny size
on the CPU (plain versions only) to check the script itself; it also exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The float32 kernels must match their plain versions to 5e-5 relative to the
# largest output (the JAX kernels' bar was 4.01e-5). In bfloat16 both round
# their outputs (and intermediates) to 8 significant bits, and a different
# summation order can move a value to the neighbouring bf16 number: the bound
# is two bf16 ulps at the largest output, 2**-6 of it. K4's float32 lse (a
# log-sum of exponentials of float32 scores) must match to 1e-4 abs.
F32_REL_BOUND = 5e-5
BF16_REL_BOUND = 2.0**-6
LSE_F32_ABS_BOUND = 1e-4
PROBA_ABS_BOUND = 1e-4
# merged against split float32 answers: the padded keys get exactly zero
# weight, so the two differ by summation order only (the JAX package's bar)
MERGE_ABS_BOUND = 1e-5
# the flagship ensemble's member widths, the image tokens of MGM+CAP 16/8
MERGE_WIDTHS, N_IMG_TOKENS = (39, 39, 22, 22), 8

# Published peaks of one H100 SXM (dense, at the full 700 W power limit):
# tensor-core bf16 and CUDA-core float32 FLOP/s, and HBM3 bytes/s
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12

KERNELS = {
    "K1": dict(
        name="K1 feature attention + residual + LN (item-major)",
        source="multimodalpfn_tpu_torch/csrc/feat_attn.cu",
        replaces="multimodalpfn_tpu/ops/pallas_fused.py:472",
    ),
    "K2a": dict(
        name="K2a item attention with QKV projection (two-block, multiquery test)",
        source="multimodalpfn_tpu_torch/csrc/item_attn.cu",
        replaces="multimodalpfn_tpu/ops/pallas_item_fused.py:200",
    ),
    "K2b": dict(
        name="K2b item out-projection + residual + LN",
        source="multimodalpfn_tpu_torch/csrc/item_epilogue.cu",
        replaces="multimodalpfn_tpu/ops/pallas_item_fused.py:679",
    ),
    "K3": dict(
        name="K3 MLP + residual + LN",
        source="multimodalpfn_tpu_torch/csrc/mlp_ln.cu",
        replaces="multimodalpfn_tpu/ops/pallas_fused.py:160",
    ),
    "K4": dict(
        name="K4 flash attention forward (o, lse; multiquery by folding heads)",
        source="multimodalpfn_tpu_torch/csrc/flash_fwd.cu",
        replaces="multimodalpfn_tpu/ops/pallas_attention.py:198",
    ),
    "K5": dict(
        name="K5 feature attention + residual + LN (sample-major)",
        source="multimodalpfn_tpu_torch/csrc/feat_attn.cu",
        replaces="multimodalpfn_tpu/ops/pallas_fused.py:388",
    ),
    "K6a": dict(
        name="K6a key-masked feature attention + residual + LN (item-major, a mask per member)",
        source="multimodalpfn_tpu_torch/csrc/feat_attn.cu",
        replaces="multimodalpfn_tpu/ops/pallas_fused.py:303",
    ),
    "K6b": dict(
        name="K6b key-masked feature attention + residual + LN (sample-major, a mask per member)",
        source="multimodalpfn_tpu_torch/csrc/feat_attn.cu",
        replaces="multimodalpfn_tpu/ops/pallas_fused.py:280",
    ),
}
# the served path each kernel's launch count comes from: phases 3 and 5 serve
# the cost rule's plan; phase 7 the split groups (K1, K5) and the merged one
# (K6a, K6b) whatever the rule plans
PATH_OF = {"K1": "split", "K2a": "preproc", "K2b": "preproc", "K3": "preproc",
           "K4": "cached", "K5": "split_cached", "K6a": "merged", "K6b": "merged_cached"}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def timed(fn, device, iters: int) -> float:
    """Mean ms per call over ``iters`` calls after one warm-up call."""
    import torch

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, tag: str) -> tuple[float, str]:
    """The least time in ms the card could take for ``flops`` operations and
    ``nbytes`` of device-memory traffic, and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS[tag], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def densify(params: dict, seed: int) -> None:
    """Fill the output projections in place from a seeded generator. The
    published init zeroes them (`layer.py:192,232`), which multiplies every
    attention and MLP result by zero and would hide the kernels' outputs from
    the end-to-end checks."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    layers = params["layers"]
    for w in (layers["attn_feat"]["w_out"], layers["attn_item"]["w_out"], layers["mlp"]["w2"]):
        w.copy_(torch.randn(w.shape, generator=gen) * (1.0 / w.shape[-2] ** 0.5))


def write_model(path: Path) -> None:
    """The served model: the published architecture with MGM+CAP 16/8, random
    weights from seed 0, densified from seed 1, as an ``.npz``."""
    from multimodalpfn_tpu_torch.models.loading import load_model, save_npz

    loaded = load_model("random:0", mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8)
    densify(loaded.params, seed=1)
    path.parent.mkdir(parents=True, exist_ok=True)
    save_npz(path, loaded.params, loaded.config)


def phase_kernels(device, dims, iters) -> dict:
    """Every kernel against its plain version on the same inputs."""
    import torch
    import torch.nn.functional as F

    from multimodalpfn_tpu_torch.ops import flash, fused, item_fused

    b, t, S, sep, e, h, d, nhid, n_pred = dims
    hd = h * d
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    x = rand(b, t, S, e)
    w_qkv = rand(3, h, d, e, scale=(2.0 / (h * d + e)) ** 0.5)
    w_out = rand(h, d, e, scale=(h * d) ** -0.5)
    w1 = rand(e, nhid, scale=e**-0.5)
    w2 = rand(nhid, e, scale=nhid**-0.5)
    o_in = rand(b * t, S, hd)
    x48 = rand(b, 48, S, e)  # K1 with more tokens than 32
    xs = rand(b, sep, t, e)  # K5 at the prime shape: the train rows, sample-major
    xs48 = rand(b, sep, 48, e)
    qp, kp, vp = rand(b * t * h, sep, d), rand(b * t * h, sep, d), rand(b * t * h, sep, d)
    qm = rand(b * t, h * n_pred, d)  # multiquery: heads folded into the queries
    xp48 = rand(b, n_pred, 48, e)  # K6b at the merged predict shape
    # the merged group's key masks: each member's own feature tokens, none of
    # its padded ones, the image tokens and the target
    widths = [MERGE_WIDTHS[i % len(MERGE_WIDTHS)] for i in range(b)]
    g_max = 48 - N_IMG_TOKENS - 1
    mask = torch.ones((b, 48), dtype=torch.bool)
    for i, w in enumerate(widths):
        mask[i, w:g_max] = False
    keys = [w + N_IMG_TOKENS + 1 for w in widths]  # valid keys per member

    def feat_work(rows, tt, valid=None):
        """K1 / K5 (K6a / K6b): projections and out-projection of every token,
        attention of every query against the valid keys of its row."""
        mask_bytes = 0 if valid is None else 8 * b  # a 64-bit word per member
        valid = [tt] * b if valid is None else valid
        attn = sum(4 * (rows // b) * h * tt * kv * d for kv in valid)
        return lambda es: (2 * rows * tt * 4 * hd * e + attn,
                           2 * rows * tt * e * es + 4 * hd * e * es + mask_bytes)

    def flash_work(G, Sq, Skv):
        return lambda es: (4 * G * Sq * Skv * d, (G * Sq + 2 * G * Skv) * d * es + G * Sq * (d + 1) * 4)

    def sdpa(q, k, v):  # (G, S, d) -> one call with the G groups as heads
        return lambda: F.scaled_dot_product_attention(q[None], k[None], v[None])

    def item_sdpa(dt):
        """K2a's attention core as PyTorch calls: the projection is done
        before timing, then one call per block (train rows on every head,
        test rows on KV head 0)."""
        w2_ = w_qkv.reshape(3 * hd, e).to(dt)
        qkv = (x.reshape(b * t, S, e).to(dt) @ w2_.T).reshape(b * t, S, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1][:, :, :sep], qkv[2][:, :, :sep]
        k0, v0 = k[:, :1].expand_as(k), v[:, :1].expand_as(v)

        def run():
            F.scaled_dot_product_attention(q[:, :, :sep], k, v)
            F.scaled_dot_product_attention(q[:, :, sep:], k0, v0)
        return run

    G2, R = b * t, b * S
    cases = {
        "K1": (fused.fused_feature_attention_ln_im, fused.feature_attention_ln_im_plain,
               lambda dt: (x.to(dt), w_qkv, w_out), feat_work(R, t), None),
        "K1@t48": (fused.fused_feature_attention_ln_im, fused.feature_attention_ln_im_plain,
                   lambda dt: (x48.to(dt), w_qkv, w_out), feat_work(R, 48), None),
        "K2a": (item_fused.item_attention_core, item_fused.item_attention_core_plain,
                lambda dt: (x.reshape(G2, S, e).to(dt), w_qkv, sep),
                lambda es: (2 * G2 * S * e * 3 * hd + 4 * G2 * h * S * sep * d,
                            (G2 * S * e + 3 * hd * e + G2 * S * hd) * es + G2 * h * S * 4),
                item_sdpa),
        "K2b": (item_fused.item_epilogue_ln, item_fused.item_epilogue_ln_plain,
                lambda dt: (x.reshape(G2, S, e).to(dt), o_in.to(dt), w_out),
                lambda es: (2 * G2 * S * hd * e, (G2 * S * (2 * e + hd) + hd * e) * es), None),
        "K3": (fused.fused_mlp_ln, fused.mlp_ln_plain, lambda dt: (x.to(dt), w1, w2),
               lambda es: (4 * R * t * e * nhid, (2 * R * t * e + 2 * e * nhid) * es), None),
        "K4": (flash.flash_attention, flash.flash_attention_plain,
               lambda dt: (qp.to(dt), kp.to(dt), vp.to(dt)), flash_work(b * t * h, sep, sep),
               lambda dt: sdpa(qp.to(dt), kp.to(dt), vp.to(dt))),
        "K4@predict": (flash.flash_attention, flash.flash_attention_plain,
                       lambda dt: (qm.to(dt), kp[:G2].to(dt), vp[:G2].to(dt)),
                       flash_work(G2, h * n_pred, sep),
                       lambda dt: sdpa(qm.to(dt), kp[:G2].to(dt), vp[:G2].to(dt))),
        "K5": (fused.fused_feature_attention_ln, fused.feature_attention_ln_plain,
               lambda dt: (xs.to(dt), w_qkv, w_out), feat_work(b * sep, t), None),
        "K5@t48": (fused.fused_feature_attention_ln, fused.feature_attention_ln_plain,
                   lambda dt: (xs48.to(dt), w_qkv, w_out), feat_work(b * sep, 48), None),
        "K6a": (fused.fused_feature_attention_ln_im, fused.feature_attention_ln_im_plain,
                lambda dt: (x48.to(dt), w_qkv, w_out, mask), feat_work(R, 48, keys), None),
        "K6b": (fused.fused_feature_attention_ln, fused.feature_attention_ln_plain,
                lambda dt: (xs48.to(dt), w_qkv, w_out, None, mask[:, None]),
                feat_work(b * sep, 48, keys), None),
        "K6b@predict": (fused.fused_feature_attention_ln, fused.feature_attention_ln_plain,
                        lambda dt: (xp48.to(dt), w_qkv, w_out, None, mask[:, None]),
                        feat_work(b * n_pred, 48, keys), None),
    }
    results = {}
    for kid, (kern, plain, make, work, library) in cases.items():
        res = {"shape": list(make(torch.float32)[0].shape)}
        for dt, tag, rel_bound in (
            (torch.float32, "f32", F32_REL_BOUND),
            (torch.bfloat16, "bf16", BF16_REL_BOUND),
        ):
            args = make(dt)
            got, want = kern(*args), plain(*args)
            if isinstance(got, tuple):  # (o, lse)
                (got, got_lse), (want, want_lse) = got, want
                lse_err = float((got_lse - want_lse).abs().max())
                res[f"lse_max_abs_err_{tag}"] = lse_err
                if kid.startswith("K4") and tag == "f32":
                    check(lse_err <= LSE_F32_ABS_BOUND, f"{kid} f32 lse err {lse_err:.3e}")
            if device.type == "cuda":
                torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            rel = err / float(want.float().abs().max())
            finite = bool(torch.isfinite(got.float()).all())
            del got, want
            res[f"max_abs_err_{tag}"] = err
            res[f"rel_err_{tag}"] = rel
            res[f"ms_{tag}"] = timed(lambda: kern(*args), device, iters)
            res[f"plain_ms_{tag}"] = timed(lambda: plain(*args), device, max(1, iters // 2))
            flops, nbytes = work(2 if tag == "bf16" else 4)
            res[f"bound_ms_{tag}"], res[f"bound_by_{tag}"] = bound(flops, nbytes, tag)
            res[f"library_ms_{tag}"] = None
            if library is not None and tag == "bf16":
                res[f"library_ms_{tag}"] = timed(library(dt), device, iters)
            lib = res[f"library_ms_{tag}"]
            print(
                f"  {kid} {tag}: max abs err {err:.3e}, rel err {rel:.3e} (bound {rel_bound:.3e}), "
                f"kernel {res[f'ms_{tag}']:.3f} ms, plain {res[f'plain_ms_{tag}']:.3f} ms, "
                f"bound {res[f'bound_ms_{tag}']:.3f} ms ({res[f'bound_by_{tag}']})"
                + ("" if tag == "f32" else ", no single library call" if lib is None
                   else f", library {lib:.3f} ms"),
                flush=True,
            )
            check(finite, f"{kid} {tag}: non-finite output")
            check(rel <= rel_bound, f"{kid} {tag}: rel err {rel:.3e} > {rel_bound:.3e}")
        results[kid] = res
    return results


def make_classifier(device, model_path, **kw):
    """The served classifier: 4 members, the default preprocessing."""
    from multimodalpfn_tpu_torch import MMPFNClassifier

    return MMPFNClassifier(
        model_path=str(model_path),
        mixer_type="MGM+CAP",
        mgm_heads=16,
        cap_heads=8,
        n_estimators=4,
        device=str(device),
        **kw,
    )


def planned_groups(clf, cached: bool, request_sizes) -> list[tuple[list[int], int, bool]]:
    """The fitted classifier's member groups as the engine plans them, for
    the first request (the KV cache: for the bucket floor, when it is
    primed): (member indices, width, merged)."""
    from multimodalpfn_tpu_torch.estimator import inference as inf

    members = clf.executor_.members
    groups = inf._width_groups(members, [m.X_train.shape[1] for m in members])
    n_test = inf.TEST_SIZE_BUCKET if cached else inf._bucket_test_rows(request_sizes[0])
    plans = inf._plan_groups(groups, clf.config_, N_IMG_TOKENS, n_test, cached=cached)
    return [(idxs, width, tab_valid is not None) for idxs, width, tab_valid, _ in plans]


def check_proba(p, n_rows: int, n_classes: int, tag: str) -> None:
    import numpy as np

    check(p.shape == (n_rows, n_classes), f"{tag}: shape {p.shape}")
    check(bool(np.isfinite(p).all()), f"{tag}: non-finite probabilities")
    check(float(np.abs(p.sum(axis=1) - 1).max()) < 1e-6, f"{tag}: rows do not sum to 1")


def phase_served(device, model_path, data, request_sizes, n_layers, fit_mode) -> dict:
    """Fit once, then the predict requests through the public API, with the
    launch counters zeroed just before (fit_with_cache: before the fit, whose
    prime launches kernels too) and read just after."""
    import torch

    from multimodalpfn_tpu_torch.ops import kernels

    X_tr, img_tr, y_tr, X_te, img_te = data
    cached = fit_mode == "fit_with_cache"
    clf = make_classifier(device, model_path, fit_mode=fit_mode)
    if cached:
        kernels.reset_launches()
    t0 = time.perf_counter()
    clf.fit(X_tr, img_tr, y_tr)
    if device.type == "cuda":
        torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    widths = [m.X_train.shape[1] for m in clf.executor_.members]
    plans = planned_groups(clf, cached, request_sizes)
    groups, merged = len(plans), sum(m for _, _, m in plans)
    print(f"  fit {fit_ms:.1f} ms; member widths {widths}; planned groups "
          f"{[(idxs, w, 'merged' if m else 'one width') for idxs, w, m in plans]}", flush=True)

    if not cached:
        kernels.reset_launches()
    times, answers = [], []
    for n in request_sizes:
        t0 = time.perf_counter()
        p = clf.predict_proba(X_te[:n], img_te[:n])
        times.append((time.perf_counter() - t0) * 1e3)
        check_proba(p, n, clf.n_classes_, f"request of {n} rows")
        answers.append(p)
        print(f"  predict_proba({n} rows): {times[-1]:.1f} ms", flush=True)
    launches = dict(kernels.LAUNCHES)
    passes = len(request_sizes) + 1 if cached else len(request_sizes)
    # per kernel, the launches every layer of every planned group and pass
    # needs at least (a memory split of a group adds more)
    if cached:
        feat, masked, idle = "K5", "K6b", ("K1", "K2a", "K2b", "K6a")
        need = {"K4": groups, "K3": groups}
    else:
        feat, masked, idle = "K1", "K6a", ("K4", "K5", "K6b")
        need = {"K2a": groups, "K2b": groups, "K3": groups}
    need |= {feat: groups - merged, masked: merged}
    need = {k: n_layers * passes * n for k, n in need.items()}
    idle += tuple(k for k, n in need.items() if n == 0)
    print(f"  launches {launches} (at least {need}; {', '.join(idle)} 0)", flush=True)
    if device.type == "cuda":
        for kid, n in need.items():
            check(launches[kid] >= n, f"{kid} launched {launches[kid]} times, expected >= {n}")
        for kid in idle:
            check(launches[kid] == 0, f"{kid} launched {launches[kid]} times on the {fit_mode} path")
    warm = []  # the same requests again, each now at a sequence length seen before
    for n in request_sizes:
        t0 = time.perf_counter()
        clf.predict_proba(X_te[:n], img_te[:n])
        warm.append((time.perf_counter() - t0) * 1e3)
    print(f"  warm requests: {', '.join(f'{ms:.1f}' for ms in warm)} ms", flush=True)
    out = dict(launches=launches, fit_ms=fit_ms, times=times, warm=warm, answers=answers,
               widths=widths, plans=plans)
    if cached:
        reqs = [(X_te[:n], img_te[:n]) for n in request_sizes]
        t0 = time.perf_counter()
        many = clf.predict_proba_many([r[0] for r in reqs], [r[1] for r in reqs])
        out["many_ms"] = (time.perf_counter() - t0) * 1e3
        same = all(a.shape == b.shape and bool((a == b).all()) for a, b in zip(many, answers))
        print(f"  predict_proba_many over the {len(reqs)} requests: {out['many_ms']:.1f} ms, "
              f"equal to the sequential answers: {same}", flush=True)
        check(same, "predict_proba_many differs from sequential predict_proba")
    return out


def phase_kernel_vs_plain(device, model_path, data, fit_mode, tag="") -> tuple[float, object]:
    """float32 predict_proba of the kernel path against the plain path of the
    same fitted classifier (fit_with_cache primes again for each path).
    Returns the error and the kernel path's answers."""
    X_tr, img_tr, y_tr, X_te, img_te = data
    clf = make_classifier(device, model_path, inference_precision="float32", fit_mode=fit_mode)
    clf.fit(X_tr, img_tr, y_tr)
    clf.executor_.use_kernels = True  # the default on CUDA; explicit for --rehearse
    p_kernel = clf.predict_proba(X_te, img_te)
    # the plain path materializes (b, t, h, S, S) scores; the memory estimate
    # sizes its forwards (and for fit_with_cache its prime)
    clf.executor_.use_kernels = False
    p_plain = clf.predict_proba(X_te, img_te)
    for p, name in ((p_kernel, "kernel path"), (p_plain, "plain path")):
        check_proba(p, len(X_te), clf.n_classes_, f"{fit_mode}{tag} {name}")
    err = float(abs(p_kernel - p_plain).max())
    print(f"  f32 {fit_mode}{tag} predict_proba kernel vs plain: max abs err {err:.3e} "
          f"(bound {PROBA_ABS_BOUND})", flush=True)
    check(err <= PROBA_ABS_BOUND, f"{fit_mode}{tag}: kernel path differs from plain path by {err:.3e}")
    return err, p_kernel


def phase_forced_plans(device, model_path, data, request_sizes, n_layers) -> dict:
    """The member widths forced into split groups and into one padded group,
    in both fit modes, whatever the cost rule plans. In bf16: the launch
    counts (zeroed just before the fit; split groups run K1 / K5 in every
    layer and no masked kernel, the merged group K6a / K6b and no unmasked
    one) and warm requests. In float32: merged against split answers, and the
    merged kernel path against the merged plain path."""
    import torch

    from multimodalpfn_tpu_torch.estimator import inference as inf
    from multimodalpfn_tpu_torch.ops import kernels

    X_tr, img_tr, y_tr, X_te, img_te = data
    out = {}
    try:
        for fit_mode in ("fit_preprocessors", "fit_with_cache"):
            cached = fit_mode == "fit_with_cache"
            for force in (False, True):
                plan = "merged" if force else "split"
                inf._FORCE_MERGE = force
                clf = make_classifier(device, model_path, fit_mode=fit_mode)
                kernels.reset_launches()
                clf.fit(X_tr, img_tr, y_tr)
                plans = planned_groups(clf, cached, request_sizes)
                check(all(m == force for _, _, m in plans) and (len(plans) == 1) == force,
                      f"{fit_mode}: planned groups {plans} are not {plan}")
                at_fit = dict(kernels.LAUNCHES)
                kernels.reset_launches()
                for n in request_sizes:
                    check_proba(clf.predict_proba(X_te[:n], img_te[:n]), n, clf.n_classes_,
                                f"{plan} {fit_mode} request of {n} rows")
                launches = dict(kernels.LAUNCHES)
                kid, idle = {(False, False): ("K1", "K6a"), (False, True): ("K6a", "K1"),
                             (True, False): ("K5", "K6b"), (True, True): ("K6b", "K5")}[cached, force]
                need = n_layers * len(plans)
                print(f"  {plan} {fit_mode} ({len(plans)} group(s)): launches at the fit {at_fit}, "
                      f"over the {len(request_sizes)} requests {launches} ({kid} >= "
                      f"{need * len(request_sizes)}" + (f", and >= {need} at the fit" if cached else "")
                      + f"; {idle} 0)", flush=True)
                if device.type == "cuda":
                    check(launches[kid] >= need * len(request_sizes),
                          f"{kid} launched {launches[kid]} times in the {plan} {fit_mode} requests")
                    check(at_fit[kid] >= (need if cached else 0),
                          f"{kid} launched {at_fit[kid]} times at the {plan} {fit_mode} fit")
                    check(launches[idle] == 0 and at_fit[idle] == 0,
                          f"{idle} ran in the {plan} {fit_mode} groups")
                warm = []
                for n in request_sizes:
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    clf.predict_proba(X_te[:n], img_te[:n])
                    warm.append((time.perf_counter() - t0) * 1e3)
                print(f"  {plan} {fit_mode} warm requests: {', '.join(f'{ms:.1f}' for ms in warm)} ms",
                      flush=True)
                out[fit_mode, plan] = dict(launches={k: at_fit[k] + launches[k] for k in launches},
                                           warm=warm)
            # float32: the split answers, then the merged kernel and plain paths
            inf._FORCE_MERGE = False
            p_split = make_classifier(device, model_path, inference_precision="float32",
                                      fit_mode=fit_mode).fit(X_tr, img_tr, y_tr).predict_proba(X_te, img_te)
            inf._FORCE_MERGE = True
            err_plain, p_merged = phase_kernel_vs_plain(device, model_path, data, fit_mode,
                                                        tag=" merged")
            diff = float(abs(p_merged - p_split).max())
            print(f"  f32 {fit_mode} merged vs split predict_proba: max abs err {diff:.3e} "
                  f"(bound {MERGE_ABS_BOUND})", flush=True)
            check(diff <= MERGE_ABS_BOUND, f"{fit_mode}: merged answers differ from split by {diff:.3e}")
            out[fit_mode, "merged"] |= dict(merged_vs_split=diff, merged_kernel_vs_plain=err_plain)
    finally:
        inf._FORCE_MERGE = None
    return out


def phase_profile(device, model_path, data, request_sizes, top: int = 14) -> None:
    """torch.profiler around one warm request of each size in both modes:
    wall time (host clock around ``predict_proba``), the sum of device kernel
    times, the idle share ``1 - kernel / wall`` and the kernels that took the
    most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    X_tr, img_tr, y_tr, X_te, img_te = data
    for fit_mode in ("fit_preprocessors", "fit_with_cache"):
        clf = make_classifier(device, model_path, fit_mode=fit_mode)
        clf.fit(X_tr, img_tr, y_tr)
        for n in request_sizes:  # every sequence length once, so the profiled requests are warm
            clf.predict_proba(X_te[:n], img_te[:n])
        for n in request_sizes:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                clf.predict_proba(X_te[:n], img_te[:n])
                wall = (time.perf_counter() - t0) * 1e3
            rows = []
            for ev in prof.key_averages():
                dt = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
                if dt and ev.device_type == torch.autograd.DeviceType.CUDA:
                    rows.append((dt / 1e3, ev.count, ev.key[:90]))
            rows.sort(reverse=True)
            busy = sum(r[0] for r in rows)
            print(f"  {fit_mode} request of {n} rows: wall {wall:.2f} ms, device kernel time "
                  f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}", flush=True)
            for ms, count, key in rows[:top]:
                print(f"    {ms:9.3f} ms  x{count:4d}  {key}", flush=True)


def kernel_rows(kres: dict, launches: dict) -> list[dict]:
    """The ``kernels`` line: per kernel its bf16 numbers at the first shape
    (``ms`` etc.), every other measurement under its own key."""
    rows = []
    for kid, meta in KERNELS.items():
        r = dict(kres[kid])
        for sub in ("t48", "predict"):
            r.update({f"{k}_{sub}": v for k, v in kres.get(f"{kid}@{sub}", {}).items()})
        main = {"max_abs_err": "max_abs_err_f32", "ms": "ms_bf16", "plain_ms": "plain_ms_bf16",
                "bound_ms": "bound_ms_bf16", "bound_by": "bound_by_bf16",
                "library_ms": "library_ms_bf16"}
        row = {"name": meta["name"], "route": "cuda", "source": meta["source"],
               "replaces": meta["replaces"], "launches": launches[PATH_OF[kid]][kid]}
        row.update({k: r[v] for k, v in main.items()})
        if kid == "K3":
            row["launches_cached"] = launches["cached"]["K3"]
        row.update({k: v for k, v in r.items() if k not in main.values()})
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase at a tiny size on the CPU; exits 1")
    ap.add_argument("--profile", action="store_true",
                    help="add phase 7: profile one warm request of each size")
    args = ap.parse_args()

    if not (ROOT / "multimodalpfn_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("CUDA is not available: nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from multimodalpfn_tpu_torch.datasets.synthetic import pad_ufes_like
    from multimodalpfn_tpu_torch.ops import kernels

    device = torch.device("cpu" if args.rehearse else "cuda")
    t_start = time.perf_counter()

    print("== phase 1: setup", flush=True)
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        print(smi.stdout.strip().splitlines()[0], flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        kernels.build(verbose=True)
        kernels.library()
        print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s "
              f"({kernels.library_path().name})", flush=True)
    model_path = ROOT / "build" / "chip_smoke_model.npz"
    write_model(model_path)

    print("== phase 2: kernels against their plain versions", flush=True)
    if args.rehearse:
        dims, iters = (2, 7, 40, 30, 32, 4, 8, 64, 16), 1
    else:
        dims, iters = (4, 31, 2350, 1838, 192, 6, 32, 768, 512), 10
    kres = phase_kernels(device, dims, iters)

    X, img, y = pad_ufes_like(seed=0)
    if args.rehearse:
        X, img, y = X[:150], img[:150], y[:150]
    n_tr = int(round(0.8 * len(X)))
    data = (X[:n_tr], img[:n_tr], y[:n_tr], X[n_tr:], img[n_tr:])
    sizes = [len(X) - n_tr, min(128, len(X) - n_tr), min(300, len(X) - n_tr)]

    print("== phase 3: fit_preprocessors, served", flush=True)
    pre = phase_served(device, model_path, data, sizes, 12, "fit_preprocessors")
    print("== phase 4: fit_preprocessors kernel path against plain path (float32)", flush=True)
    proba_err, _ = phase_kernel_vs_plain(device, model_path, data, "fit_preprocessors")

    print("== phase 5: fit_with_cache, served", flush=True)
    kv = phase_served(device, model_path, data, sizes, 12, "fit_with_cache")
    diff = max(float(abs(a - b).max()) for a, b in zip(kv["answers"], pre["answers"]))
    print(f"  cached vs fit_preprocessors answers: max abs difference {diff:.3e} "
          "(not gated: the encoder masks differ by design)", flush=True)
    print("== phase 6: fit_with_cache kernel path against plain path (float32)", flush=True)
    kv_err, _ = phase_kernel_vs_plain(device, model_path, data, "fit_with_cache")

    print("== phase 7: the member widths forced split and merged, both fit modes", flush=True)
    from multimodalpfn_tpu_torch.estimator import inference as inf
    from multimodalpfn_tpu_torch.models.loading import load_npz

    for cached, n_test in ((False, inf._bucket_test_rows(sizes[0])), (True, inf.TEST_SIZE_BUCKET)):
        rule = inf._plan_groups({(39, n_tr): [0, 1], (22, n_tr): [2, 3]},
                                load_npz(model_path).config, N_IMG_TOKENS, n_test, cached=cached)
        print(f"  the cost rule at widths 39/39/22/22, {n_tr} train rows, {n_test} test rows"
              f"{' (KV-cache predict)' if cached else ''}: {'split' if len(rule) == 2 else 'merge'}",
              flush=True)
    forced = phase_forced_plans(device, model_path, data, sizes, 12)
    for mode in ("fit_preprocessors", "fit_with_cache"):
        print(f"  {mode} warm requests (ms): split {forced[mode, 'split']['warm']}, merged "
              f"{forced[mode, 'merged']['warm']}", flush=True)

    if args.profile:
        print("== phase 8: profile of warm requests", flush=True)
        phase_profile(device, model_path, data, sizes)

    rows = kernel_rows(kres, {"preproc": pre["launches"], "cached": kv["launches"]}
                       | {f"{plan}{'_cached' if mode == 'fit_with_cache' else ''}": run["launches"]
                          for (mode, plan), run in forced.items()})
    print(f"  fit_preprocessors: fit {pre['fit_ms']:.1f} ms, requests ms {pre['times']}, "
          f"warm {pre['warm']}; fit_with_cache: fit {kv['fit_ms']:.1f} ms, requests ms "
          f"{kv['times']}, warm {kv['warm']}, "
          f"predict_proba_many {kv['many_ms']:.1f} ms; f32 proba err {proba_err:.3e} "
          f"(cached {kv_err:.3e}); total {time.perf_counter() - t_start:.1f} s", flush=True)
    if args.rehearse:
        print("rehearsal on the CPU passed; no result is reported without CUDA", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
