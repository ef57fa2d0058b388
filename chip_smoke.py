#!/usr/bin/env python3
"""On-card proof that the PyTorch/CUDA port (``multimodalpfn_tpu_torch``) runs.

Run from the repository root on a machine with one NVIDIA GPU (H100) and
``nvcc``:

    python3 chip_smoke.py

Phases, each of which must pass:

1. Setup: print the card (``nvidia-smi`` name and power limit), turn TF32 off,
   build the CUDA kernels from ``multimodalpfn_tpu_torch/csrc`` and print the
   build time.
2. Kernel checks: K1, K2a, K2b and K3 against their plain PyTorch versions at
   the flagship shapes (4 members, 1838 train + 460 test rows bucketed to
   2350, 31 tokens, e = 192, h = 6, d = 32, nhid = 768), in float32 and
   bfloat16, with times of kernel and plain version (CUDA events); K1 also
   at 48 tokens, which its bfloat16 kernel takes as 64 token rows per sample.
3. The slice, served: ``MMPFNClassifier`` (random weights from a seed,
   MGM+CAP, 4 members, numpy-only preprocessing) fits the PAD-UFES-shaped
   synthetic set and answers three ``predict_proba`` requests (460, 128 and
   300 test rows); the launch counters show every kernel ran in each layer.
4. Kernel path against plain path: float32 ``predict_proba`` of the kernel
   path against the same model's plain path (which the memory estimate
   splits into forwards of a few members).

``--profile`` adds a phase 5: ``torch.profiler`` around one warm request of
each size, printing wall time, device kernel time, the idle share and the
kernels that took the most device time.

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
# is two bf16 ulps at the largest output, 2**-6 of it.
F32_REL_BOUND = 5e-5
BF16_REL_BOUND = 2.0**-6
PROBA_ABS_BOUND = 1e-4

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
}


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


def phase_kernels(device, dims, iters) -> dict:
    """K1, K2a, K2b and K3 against their plain versions on the same inputs."""
    import torch

    from multimodalpfn_tpu_torch.ops import fused, item_fused

    b, t, S, sep, e, h, d, nhid = dims
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    x = rand(b, t, S, e)
    w_qkv = rand(3, h, d, e, scale=(2.0 / (h * d + e)) ** 0.5)
    w_out = rand(h, d, e, scale=(h * d) ** -0.5)
    w1 = rand(e, nhid, scale=e**-0.5)
    w2 = rand(nhid, e, scale=nhid**-0.5)
    o_in = rand(b * t, S, h * d)
    x48 = rand(b, 48, S, e)  # K1 with more tokens than 32
    cases = {
        "K1": (fused.fused_feature_attention_ln_im, fused.feature_attention_ln_im_plain,
               lambda dt: (x.to(dt), w_qkv, w_out)),
        "K1@t48": (fused.fused_feature_attention_ln_im, fused.feature_attention_ln_im_plain,
                   lambda dt: (x48.to(dt), w_qkv, w_out)),
        "K2a": (lambda *a: item_fused.item_attention_core(*a),
                lambda *a: item_fused.item_attention_core_plain(*a),
                lambda dt: (x.reshape(b * t, S, e).to(dt), w_qkv, sep)),
        "K2b": (item_fused.item_epilogue_ln, item_fused.item_epilogue_ln_plain,
                lambda dt: (x.reshape(b * t, S, e).to(dt), o_in.to(dt), w_out)),
        "K3": (fused.fused_mlp_ln, fused.mlp_ln_plain, lambda dt: (x.to(dt), w1, w2)),
    }
    results = {}
    for kid, (kern, plain, make) in cases.items():
        res = {"shape": list(make(torch.float32)[0].shape)}
        for dt, tag, bound in (
            (torch.float32, "f32", F32_REL_BOUND),
            (torch.bfloat16, "bf16", BF16_REL_BOUND),
        ):
            args = make(dt)
            got, want = kern(*args), plain(*args)
            if kid == "K2a":
                (got, got_lse), (want, want_lse) = got, want
                res[f"lse_max_abs_err_{tag}"] = float((got_lse - want_lse).abs().max())
            if device.type == "cuda":
                torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            rel = err / float(want.float().abs().max())
            finite = bool(torch.isfinite(got.float()).all())
            res[f"max_abs_err_{tag}"] = err
            res[f"rel_err_{tag}"] = rel
            res[f"ms_{tag}"] = timed(lambda: kern(*args), device, iters)
            res[f"plain_ms_{tag}"] = timed(lambda: plain(*args), device, max(1, iters // 2))
            print(
                f"  {kid} {tag}: max abs err {err:.3e}, rel err {rel:.3e} (bound {bound:.3e}), "
                f"kernel {res[f'ms_{tag}']:.3f} ms, plain {res[f'plain_ms_{tag}']:.3f} ms",
                flush=True,
            )
            check(finite, f"{kid} {tag}: non-finite output")
            check(rel <= bound, f"{kid} {tag}: rel err {rel:.3e} > {bound:.3e}")
            del got, want
        results[kid] = res
    return results


def make_classifier(device, **kw):
    from multimodalpfn_tpu_torch import MMPFNClassifier
    from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig

    return MMPFNClassifier(
        model_path="random:0",
        mixer_type="MGM+CAP",
        mgm_heads=16,
        cap_heads=8,
        n_estimators=4,
        device=str(device),
        inference_config={
            "PREPROCESS_TRANSFORMS": [
                PreprocessorConfig("none", categorical_name="numeric", subsample_features=-1)
            ]
        },
        **kw,
    )


def check_proba(p, n_rows: int, n_classes: int, tag: str) -> None:
    import numpy as np

    check(p.shape == (n_rows, n_classes), f"{tag}: shape {p.shape}")
    check(bool(np.isfinite(p).all()), f"{tag}: non-finite probabilities")
    check(float(np.abs(p.sum(axis=1) - 1).max()) < 1e-6, f"{tag}: rows do not sum to 1")


def phase_served(device, data, request_sizes, n_layers) -> tuple[dict, list]:
    """fit once, then the three predict requests through the public API."""
    from multimodalpfn_tpu_torch.ops import kernels

    X_tr, img_tr, y_tr, X_te, img_te = data
    clf = make_classifier(device)
    t0 = time.perf_counter()
    clf.fit(X_tr, img_tr, y_tr)
    fit_ms = (time.perf_counter() - t0) * 1e3
    densify(clf.params_, seed=1)
    groups = len({m.X_train.shape[1] for m in clf.executor_.members})
    print(f"  fit {fit_ms:.1f} ms; {groups} width group(s) of members", flush=True)

    kernels.reset_launches()
    times = []
    for n in request_sizes:
        t0 = time.perf_counter()
        p = clf.predict_proba(X_te[:n], img_te[:n])
        times.append((time.perf_counter() - t0) * 1e3)
        check_proba(p, n, clf.n_classes_, f"request of {n} rows")
        print(f"  predict_proba({n} rows): {times[-1]:.1f} ms", flush=True)
    launches = dict(kernels.LAUNCHES)
    need = n_layers * groups * len(request_sizes)
    print(f"  launches {launches} (each must be >= {need})", flush=True)
    if device.type == "cuda":
        for kid, n in launches.items():
            check(n >= need, f"{kid} launched {n} times, expected >= {need}")
    return launches, times


def phase_kernel_vs_plain(device, data) -> float:
    """float32 predict_proba of the kernel path against the plain path."""
    X_tr, img_tr, y_tr, X_te, img_te = data
    clf = make_classifier(device, inference_precision="float32")
    clf.fit(X_tr, img_tr, y_tr)
    densify(clf.params_, seed=1)
    clf.executor_.use_kernels = True  # the default on CUDA; explicit for --rehearse
    p_kernel = clf.predict_proba(X_te, img_te)
    # the plain path materializes (b, t, h, S, S) scores; the memory estimate
    # sizes its forwards
    clf.executor_.use_kernels = False
    p_plain = clf.predict_proba(X_te, img_te)
    for p, tag in ((p_kernel, "kernel path"), (p_plain, "plain path")):
        check_proba(p, len(X_te), clf.n_classes_, tag)
    err = float(abs(p_kernel - p_plain).max())
    print(f"  f32 predict_proba kernel vs plain: max abs err {err:.3e} (bound {PROBA_ABS_BOUND})")
    check(err <= PROBA_ABS_BOUND, f"kernel path differs from plain path by {err:.3e}")
    return err


def phase_profile(device, data, request_sizes, top: int = 14) -> None:
    """torch.profiler around one warm request of each size: wall time (host
    clock around ``predict_proba``), the sum of device kernel times, the idle
    share ``1 - kernel / wall`` and the kernels that took the most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    X_tr, img_tr, y_tr, X_te, img_te = data
    clf = make_classifier(device)
    clf.fit(X_tr, img_tr, y_tr)
    densify(clf.params_, seed=1)
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
        print(f"  request of {n} rows: wall {wall:.2f} ms, device kernel time {busy:.2f} ms, "
              f"idle share {1 - busy / wall:.3f}", flush=True)
        for ms, count, key in rows[:top]:
            print(f"    {ms:9.3f} ms  x{count:4d}  {key}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase at a tiny size on the CPU; exits 1")
    ap.add_argument("--profile", action="store_true",
                    help="add phase 5: profile one warm request of each size")
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

    print("== phase 2: kernels against their plain versions", flush=True)
    if args.rehearse:
        dims, iters = (2, 7, 40, 30, 32, 4, 8, 64), 1
    else:
        dims, iters = (4, 31, 2350, 1838, 192, 6, 32, 768), 10
    kres = phase_kernels(device, dims, iters)

    print("== phase 3: the slice, served", flush=True)
    X, img, y = pad_ufes_like(seed=0)
    if args.rehearse:
        X, img, y = X[:150], img[:150], y[:150]
    n_tr = int(round(0.8 * len(X)))
    data = (X[:n_tr], img[:n_tr], y[:n_tr], X[n_tr:], img[n_tr:])
    sizes = [len(X) - n_tr, min(128, len(X) - n_tr), min(300, len(X) - n_tr)]
    launches, req_ms = phase_served(device, data, sizes, n_layers=12)

    print("== phase 4: kernel path against plain path (float32)", flush=True)
    proba_err = phase_kernel_vs_plain(device, data)

    if args.profile:
        print("== phase 5: profile of warm requests", flush=True)
        phase_profile(device, data, sizes)

    rows = []
    for kid, meta in KERNELS.items():
        r = dict(kres[kid])
        r.update({f"{k}_t48": v for k, v in kres.get(f"{kid}@t48", {}).items()})
        rows.append({
            "name": meta["name"], "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[kid],
            "max_abs_err": r["max_abs_err_f32"], "ms": r["ms_bf16"], "plain_ms": r["plain_ms_bf16"],
            **{k: v for k, v in r.items() if k not in ("max_abs_err_f32", "ms_bf16", "plain_ms_bf16")},
        })
    print(f"  requests ms {req_ms}; f32 proba err {proba_err:.3e}; "
          f"total {time.perf_counter() - t_start:.1f} s", flush=True)
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
