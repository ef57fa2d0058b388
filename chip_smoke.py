#!/usr/bin/env python3
"""On-card proof that the PyTorch/CUDA port (``multimodalpfn_tpu_torch``) runs.

Run from the repository root on a machine with one NVIDIA GPU (H100) and
``nvcc``:

    python3 chip_smoke.py

Phases, each of which must pass:

1. Setup: print the card (``nvidia-smi`` name and power limit), turn TF32 off,
   build the CUDA kernels from ``multimodalpfn_tpu_torch/csrc`` and print the
   build time; count HGMMA in the SASS of the 18 bf16 attention kernels (the
   forward of K2a and K4, the dq and dk/dv passes of K9 and K11, each at
   d = 16, 32, 64; ``cuobjdump``), each of which must issue wgmma, and of
   the 20 instantiations of the bf16 product tile of K7-K10 and of K2a's
   projection (``gemm_tile.cuh``: five epilogues by four storage orders),
   of K3's wgmma body (``mlp_ln.cu``, e = 64, 128, 192), of the wgmma body
   of K1, K5, K6a and K6b (``feat_attn.cu``, e = 64 and 192), of K2b's
   (``item_epilogue.cu``, e = 64, 128, 192) and of the per-row attention
   of K7 and K7s (``feat_attn_bwd.cu``, ``row_wg``: forward and softmax
   backward, both layouts, d = 16, 32, 64), each of which must issue wgmma
   with no local-memory load or store; the ``-Xptxas -v`` report must hold
   no serialization warning (C75xx) for the last three (those of the
   projection's instantiation are printed); write the model every phase
   serves (the published 192×12
   architecture with MGM+CAP 16/8, random weights from seed 0, output
   projections filled in from seed 1) to ``build/``.
2. Kernel checks: each kernel against its plain PyTorch version at the shapes
   the served paths give it, in float32 and bfloat16, with times of kernel
   and plain version (CUDA events), the least time the card could take for
   the same work (``bound_ms``) and, where one PyTorch call computes the same
   function, that call's time (``library_ms``). K1, K2a, K2b and K3 at the
   ``fit_preprocessors`` shapes (4 members, 1838 train + 460 test rows bucketed
   to 2350, 31 tokens, e = 192, h = 6, d = 32, nhid = 768), K1, K2a and K2b
   also at the fine-tune episode (1, 30, 1838, 192; sep 1655), K1 also at
   48 tokens; K4 at the
   KV-cache prime shape (G = 4·31·6, 1838 × 1838), the multiquery predict
   shape (G = 4·31, 6·512 queries, 1838 keys) and the
   flash fine-tune's three blocks (train G = 180, 1655 × 1655; test G = 180,
   183 queries; folded G = 30, 6·183 queries; 1655 keys), each with SDPA
   beside it; K5 at the
   prime shape (4, 1838, 31, 192) and at 48 tokens; the key-masked K6a at
   (4, 48, 2350, 192) and K6b at the merged prime (4·1838, 48, 192) and
   predict (4·512, 48, 192) shapes, with the masks of members 39/39/22/22
   features wide (+ 8 image tokens and the target: 17 keys of the narrow
   members masked); K3 also at the cache prime (4·1838, 48, 192), the cache
   predict (4·512, 48, 192) and the fine-tune episode (1, 30, 1838, 192),
   each repeat bit-equal and beside ``torch.matmul`` on its two products
   (``matmul_ms``; two calls, so no ``library_ms``); K1, K5, K6a and K6b
   too repeat bit-equal, each beside ``torch.matmul`` on its QKV and out
   projections (``matmul_ms``); K2b repeats bit-equal beside
   ``torch.matmul`` on its out-product, K2a's projection beside it on the
   same product. The lse of K2a and K4
   must match to 1e-4 abs in both
   dtypes (K2a's bf16 lse on inputs on which its projection is exact, so
   that it holds the attention alone); K2a's projection and attention are
   timed apart (profiler kernel names) and the attention is set against
   SDPA on the attention core; K2a's and K4's exponential floor (one ex2 per
   (query, key) pair) is printed beside the bound.
3. ``fit_preprocessors`` served: ``MMPFNClassifier`` (4 members, the
   classifier's default preprocessing: quantile transform, appended
   originals, global SVD, on numpy/scipy) fits the PAD-UFES-shaped synthetic
   set and answers three ``predict_proba`` requests (460, 128 and 300 test
   rows); the members' widths and the planned groups are printed; the launch
   counters, zeroed just before, show the item-major kernels (K1, or K6a for
   a merged group; K2a, K2b, K3) ran in every layer of every group, every
   K1, K6a, K2b and K3 launch through its wgmma body; then the same
   requests again, warm.
4. Its kernel path against its plain path: float32 ``predict_proba`` (the
   plain path split by the memory estimate).
5. ``fit_with_cache`` served: fit (which primes the KV cache) and the same
   three requests; the counters, zeroed just before the fit, show K4, K5 (or
   K6b) and K3 ran in every layer of the prime and of each request (each
   through its wgmma body), and no item-major kernel ran; then the requests
   again, warm.
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
   (K6b) and no unmasked one, each launch on its wgmma body; warm requests
   of both plans are timed. In
   float32 the merged answers equal the split ones to 1e-5, and the merged
   kernel path matches the merged plain path to 1e-4.
8. Backward kernels: K7 (item-major), K8, K9 and K10 against their plain
   versions at the fine-tune shapes (one episode of the flagship: x (1, 30,
   1838, 192), 1655 train + 183 test rows, nhid 768), in float32 (5e-5) and
   bf16 (2**-6), each output relative to its own largest magnitude; each run
   twice on the same inputs must give the same bits. Times, bounds, and for
   K9 the backward of ``scaled_dot_product_attention`` over both regions.
   For bf16 K7, K7s and K8, each launch of the sequence by profiler name,
   each product beside ``torch.matmul`` on operands of its shapes, and each
   launch's bytes over the HBM rate (`bwd_products`); K7's and K7s' two
   per-row attention launches also beside their exponential floor and SDPA
   (forward, and its backward) on the same shapes as (rows·h, t, d); the
   kernels line carries the measured ones as ``products_ms``,
   ``matmul_ms`` and ``attn_sdpa_ms``.
9. ``fine_tune_mmpfn`` served: 100 bf16 steps on the PAD-UFES-shaped set (the
   full 12 layers, validation after every step); the counters, zeroed just
   before, show K7, K8, K9 and K10 launched 12 times per step, every K1
   and K2b launch (training and validation) on its wgmma body and the
   per-row attention of every K7 launch on its wgmma body; every loss and
   gradient norm finite, no step skipped, no snapshot write failed; the
   snapshot on disk differs from the base model exactly when validation
   improved, and ``MMPFNClassifier`` serves it (rows sum to 1).
10. Fine-tune kernel path against plain path: three float32 steps from the
   same seed on the first three layers (the plain path keeps every layer's
   attention scores): the first step's gradient of every leaf within 1e-5 of
   that leaf's largest magnitude, loss and gradient norm within 1e-4
   relative, the params within 1e-5 absolute; the plain path launches no
   kernel.
11. Fine-tuning with the fused item gate refused: the same random weights
   saved with ``multiquery_item_attention_for_test_set: false``,
   ``fine_tune_mmpfn`` for 100 bf16 steps; the counters show K4 forward and
   K11 backward in both item blocks of every layer (K11 24 times a step),
   no K2a, K2b, K9 or K10, and the per-row attention of every K7 and K7s
   launch on its wgmma body; the snapshot keeps the key, is the best one, and
   ``MMPFNClassifier`` serves it through K4. Before it, in the same zeroed
   count, the public sample-major sublayer ``fused_feature_attention_ln`` is
   differentiated once at the flagship episode's shape (K5 forward, K7s
   backward): no served or training path of either package reaches K7s.
12. Its kernel path against the plain path, float32, as phase 10: on the
   checkpoint without the multiquery test block, and on the multiquery one
   with ``fused_item=False`` (the folded K11).
13. Resume: 6 bf16 steps with the state written every 4 (before step 4, so
   the file holds the state after step 3), restored bit for bit into a fresh
   state, then ``resume=True`` goes on from step 4 to step 6.

Phase 8 also holds K7s at x (1, 1838, 30, 192) and K11 at the flash path's
three blocks (train G = 180, Sq = Skv = 1655; test G = 180, Sq = 183; the
folded test block G = 30, Sq = 6·183 = 1098; d = 32) to their plain
versions, with SDPA's backward as K11's yardstick. For K9 and K11 it prints
the dq and dk/dv passes' device times apart (profiler kernel names) and an
exponential floor beside the bound (every (query, key) pair exponentiated
once a pass, 16 ex2 a clock per SM at the card's maximum SM clock), and it
holds their float32 outputs (and K11's bf16 at d = 8), which the CUDA-core
bodies compute, to the parent commit's bits (`PARENT_F32_SHA256`); so too
K4's and K2a's float32 outputs and bf16 at d = 8 (`attn::cc_rows`), the
float32 outputs of K7, K7s, K8 and K10 (`gemm_tile.cuh`'s cc_kernel and the
row kernels), K7's and K7s' bf16 outputs at d = 8 (their per-row warp
kernels), K3's and K2b's float32 outputs (their CUDA-core bodies) and
bf16 outputs at e = 96 (their mma.sync bodies), and the float32 outputs of
K1, K5, K6a and K6b and K5's bf16 outputs at e = 96 (`feat_attn.cu`'s
CUDA-core body).

``--profile`` adds a phase 14: ``torch.profiler`` around one warm request of
each size in both modes and around one warm training step of each item path
(the fused item sublayer and the flash path), printing wall time, device
kernel time, the idle share and the kernels that took the most device
time.

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
# The lse of K2a and K4 (a log-sum of exponentials of float32 scores, in both
# dtypes) must match to 1e-4 abs: K9 and K11 recompute every weight from it,
# so a shifted lse scales each one.
LSE_ABS_BOUND = 1e-4
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
# MUFU.EX2 results per clock per SM on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput): the floor of the
# attention kernels' exponentials, one per (query, key) pair a pass
EX2_PER_CLOCK_PER_SM = 16

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
    "K7": dict(
        name="K7 backward of K1 (item-major): dx, dW_qkv, dW_out",
        source="multimodalpfn_tpu_torch/csrc/feat_attn_bwd.cu",
        replaces="multimodalpfn_tpu/ops/pallas_fused.py:1070",
    ),
    "K8": dict(
        name="K8 backward of K3: dx, dW1, dW2",
        source="multimodalpfn_tpu_torch/csrc/mlp_ln_bwd.cu",
        replaces="multimodalpfn_tpu/ops/pallas_fused.py:709",
    ),
    "K9": dict(
        name="K9 backward of K2a (self and cross regions, QKV recomputed): dx, dW_qkv",
        source="multimodalpfn_tpu_torch/csrc/item_attn_bwd.cu",
        replaces="multimodalpfn_tpu/ops/pallas_item_fused.py:439",
    ),
    "K10": dict(
        name="K10 backward of K2b: du, do, per-head delta, dW_out",
        source="multimodalpfn_tpu_torch/csrc/item_epilogue_bwd.cu",
        replaces="multimodalpfn_tpu/ops/pallas_item_fused.py:696",
    ),
    "K7s": dict(
        name="K7s backward of K5 (sample-major): dx, dW_qkv, dW_out",
        source="multimodalpfn_tpu_torch/csrc/feat_attn_bwd.cu",
        replaces="multimodalpfn_tpu/ops/pallas_fused.py:1024",
    ),
    "K11": dict(
        name="K11 flash attention backward from the saved o, lse: dq, dk, dv (folded heads summed)",
        source="multimodalpfn_tpu_torch/csrc/flash_bwd.cu",
        replaces="multimodalpfn_tpu/ops/pallas_attention.py:333",
    ),
}
# `f32_fingerprints` on an H100 80GB HBM3 of the commits before each bf16
# redesign (K9, K11: 32e8513, before their passes moved to wgmma; K4, K2a:
# 4f9071f, before their forward did; K7, K7s, K8, K10: 661c4b4, before the
# product tile did; K3: ede4bbd, before its wgmma body; K1, K5, K6a, K6b:
# 3db1a8b, before theirs; K2b: 4125216, before its wgmma body, whose
# "K2a bf16 d=8" equals 4f9071f's although K2a's bf16 projection moved to
# the product tile; the bf16 d = 8 keys of K7 and K7s: 7f26c34, before
# their per-row attention's wgmma body): the CUDA-core bodies (float32,
# and bf16 at d = 8 or e = 96) and the mma.sync bodies of K3 and K2b must
# go on giving these bits
PARENT_F32_SHA256 = {
    "K11 f32 d=8": "b9f0e3a2bc2964aa", "K11 f32 d=16": "b910ce43502031dc",
    "K11 f32 d=32": "4055da75ae152101", "K11 f32 d=64": "8d25581c0adcb482",
    "K11 bf16 d=8": "f08cbd5d6befbdc3", "K9 f32 d=16": "316bb5119ccb572e",
    "K9 f32 d=32": "c392cb97580252e8",
    "K4 f32 d=8": "e3120a6cef7fdb84", "K4 f32 d=16": "958edca163ae9a69",
    "K4 f32 d=32": "43c8d595c221bc21", "K4 f32 d=64": "b83b6d8fa95cec24",
    "K4 bf16 d=8": "55c558b98b8ab344", "K2a f32 d=8": "a24a3210b8ee60a2",
    "K2a f32 d=16": "ac6db837ce5d7a7e", "K2a f32 d=32": "50a91845e15f9ced",
    "K2a f32 d=64": "35568848dcbde803", "K2a bf16 d=8": "d4a47c31e5c7a20a",
    "K7 f32": "2e4e66085b349fd4", "K7s f32": "9ff86b363935af49", "K8 f32": "14c4dab8f5d35cd6",
    "K10 f32": "050187159db35e72", "K3 f32": "1fd70dde3def5c63", "K3 bf16 e=96": "85d7fbe399f1b6c3",
    "K1 f32": "da7fcfc122933dd0", "K5 f32": "293dd2d20ed420c1", "K6a f32": "5e65a88ded4555cb",
    "K6b f32": "56943489eeb2bb17", "K5 bf16 e=96": "cb9035e58a023f42",
    "K2b f32": "7ab68ec6b93b7270", "K2b bf16 e=96": "89ff1226d8fa41fc",
    "K7 bf16 d=8": "6c8acd35f9c00bb0", "K7s bf16 d=8": "f7f80118ea150945",
}
# the served path each kernel's launch count comes from: phases 3 and 5 serve
# the cost rule's plan; phase 7 the split groups (K1, K5) and the merged one
# (K6a, K6b) whatever the rule plans
PATH_OF = {"K1": "split", "K2a": "preproc", "K2b": "preproc", "K3": "preproc",
           "K4": "cached", "K5": "split_cached", "K6a": "merged", "K6b": "merged_cached",
           "K7": "finetune", "K8": "finetune", "K9": "finetune", "K10": "finetune",
           "K7s": "flash_finetune", "K11": "flash_finetune"}

# The fine-tune flagship: `fine_tune_mmpfn` on `pad_ufes_like(seed=0)` keeps
# 1838 of the 2298 rows for training; an episode is one fold of a 10-fold
# split, 1655 train + 183 test rows of 21 + 8 + 1 = 30 tokens, one per step:
# (b, t, S, sep, e, h, d, nhid) of the backward kernels
FT_DIMS = (1, 30, 1838, 1655, 192, 6, 32, 768)
FT_STEPS = 100
# float32 kernel path against plain path over three training steps: loss and
# gradient norm relative, params after the steps absolute, and the first
# step's gradient of every leaf relative to that leaf's largest magnitude (at
# the default learning rate 1e-5 the params move by about 1e-5 a step, so
# only the gradients themselves show a wrong backward)
FT_STEP_REL_BOUND = 1e-4
FT_PARAM_ABS_BOUND = 1e-5
FT_GRAD_REL_BOUND = 1e-5
# the plain path keeps every layer's (30, 6, 1838, 1655) float32 attention
# scores and weights for its backward (about 6 GB a layer): the comparison
# runs the first layers of the model
FT_CMP_LAYERS = 3
# resume: the first call's steps and state cadence (the state is written
# before step 4, so it holds the state after step 3; the resumed call runs
# steps 4 to 6)
RESUME_STEPS, RESUME_EVERY = 6, 4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# the kernels with a wgmma body chosen by width (`ops/fused.py`:
# `feat_attn_body`, `mlp_ln_body`; `ops/item_fused.py`: `item_epilogue_body`)
FEAT_IDS = ("K1", "K5", "K6a", "K6b")


def check_wgmma_bodies(path: str, launches: dict, bodies: dict,
                       kids=("K2b", "K3") + FEAT_IDS) -> None:
    """Every launch of each of ``kids`` on ``path`` took its wgmma body."""
    for kid in kids:
        check(bodies[f"{kid} wgmma"] == launches[kid],
              f"{kid} ran { {k: v for k, v in bodies.items() if k.startswith(kid + ' ')} } of its "
              f"{launches[kid]} launches on the {path} path, not its wgmma body alone")


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


def wgmma_sass_counts(lib: Path) -> tuple[dict, dict, dict, dict, dict, dict]:
    """HGMMA instructions in the SASS (``cuobjdump --dump-sass``) of each
    bf16 tensor-core kernel: the attention forward of K2a and K4
    (`csrc/attn_tile.cuh`) and the dq and dk/dv passes of K9 and K11
    (`csrc/attn_bwd.cuh`), each at d = 16, 32, 64 (18 kernels); and of the
    product tile of `csrc/gemm_tile.cuh` by epilogue and transposes, of
    K3's wgmma body (`csrc/mlp_ln.cu`) by width, of the wgmma body of K1,
    K5, K6a and K6b (`csrc/feat_attn.cu`) by width, layout and mask, of
    K2b's wgmma body (`csrc/item_epilogue.cu`) by width and of the per-row
    attention of K7 and K7s (`csrc/feat_attn_bwd.cu`, `row_wg`) by pass,
    layout and d, each with its local-memory loads and stores (spills)
    beside. Returns (attention counts, {product kernel: (HGMMA, LDL +
    STL)}, {K3 kernel: (HGMMA, LDL + STL)}, {feature-attention kernel:
    (HGMMA, LDL + STL)}, {K2b kernel: (HGMMA, LDL + STL)}, {row-attention
    kernel: (HGMMA, LDL + STL)})."""
    import os
    import re
    import shutil

    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    proc = subprocess.Popen([tool, "--dump-sass", str(lib)], stdout=subprocess.PIPE, text=True)
    counts, gemm, k3, feat, k2b, rows, fn, gfn = {}, {}, {}, {}, {}, {}, None, None
    for line in proc.stdout:
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            fn = gfn = None
            if "mlp_ln_wg_kernel" in name:
                gfn = f"K3 e={re.search(r'mlp_ln_wg_kernelILi(\d+)E', name).group(1)}"
                k3.setdefault(gfn, [0, 0])
            elif "epilogue_ln_wg_kernel" in name:
                gfn = f"K2b e={re.search(r'epilogue_ln_wg_kernelILi(\d+)E', name).group(1)}"
                k2b.setdefault(gfn, [0, 0])
            elif "feat_attn_wg_kernel" in name:
                e, d, sm, masked = re.search(
                    r"feat_attn_wg_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E", name).groups()
                gfn = (f"{('K6b' if int(masked) else 'K5') if int(sm) else ('K6a' if int(masked) else 'K1')}"
                       f" e={e} d={d}")
                feat.setdefault(gfn, [0, 0])
            elif "row_wg" in name:
                d, sm, bwd = re.search(r"attn_wg_kernelILi(\d+)ELb(\d)ELb(\d)E", name).groups()
                gfn = f"{'K7s' if int(sm) else 'K7'} {'bwd' if int(bwd) else 'fwd'} d={d}"
                rows.setdefault(gfn, [0, 0])
            elif "wg_kernel" in name:
                d = re.search(r"wg_kernelILi(\d+)", name).group(1)
                if "fwd_wg_kernel" in name:
                    fn = f"{'K2a' if 'ItemFwdGeo' in name else 'K4'} fwd d={d}"
                else:
                    pas = "dq" if "dq_wg_kernel" in name else "dkv"
                    fn = f"{'K9' if 'ItemGeo' in name else 'K11'} {pas} d={d}"
                counts[fn] = 0
            elif "wgmma_kernel" in name:
                at, bt = re.search(r"wgmma_kernelILb(\d)ELb(\d)E", name).groups()
                epi = next(e for e in ("GeluEpi", "MulEpi", "AddStore", "Partial", "Store") if e in name)
                gfn = f"{epi} a_t={at} b_t={bt}"
                gemm.setdefault(gfn, [0, 0])
        elif fn and "HGMMA" in line:
            counts[fn] += 1
        elif gfn and ("HGMMA" in line or re.search(r"\b(LDL|STL)\b", line)):
            table = (k3 if gfn.startswith("K3") else k2b if gfn.startswith("K2b")
                     else rows if gfn.startswith("K7") else gemm if gfn in gemm else feat)
            table[gfn][0 if "HGMMA" in line else 1] += 1
    check(proc.wait(timeout=300) == 0, "cuobjdump failed")
    return counts, *({k: tuple(v) for k, v in t.items()} for t in (gemm, k3, feat, k2b, rows))


# the mangled name of `gemm_tile.cuh`'s wgmma_kernel<false, true,
# Store<__nv_bfloat16>>: K2a's projection and K9's recomputed qkv
PROJ_INSTANTIATION = "wgmma_kernelILb0ELb1ENS_5StoreI13__nv_bfloat16"


def serialized_wgmma(log: str, pattern: str) -> list[str]:
    """The lines of a ``-Xptxas -v`` report (`kernels.build_log`) in which
    ptxas says it serialized the wgmma of a kernel whose name contains
    ``pattern`` (warnings C7514-C7520)."""
    import re

    return [ln for ln in log.splitlines() if re.search(r"\(C75\d\d\)", ln) and pattern in ln]


def exp_floor_ms(pairs: float, device) -> float | None:
    """The least time in ms the card's SFUs take for ``pairs`` ex2 results:
    16 a clock per SM at the maximum SM clock that nvidia-smi reports."""
    import torch

    if device.type != "cuda":
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    hz = float(smi.stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return pairs / (EX2_PER_CLOCK_PER_SM * sms * hz) * 1e3


def profiled_ms(fn, device, iters: int, patterns: dict) -> dict:
    """Device ms per call of ``fn``'s kernels whose profiler names contain
    each pattern (a string, or a tuple of them): {key: pattern} -> {key: ms}."""
    import torch

    if device.type != "cuda":
        return {}
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(patterns, 0.0)
    for ms, _, name in device_kernel_rows(prof):
        for key, pattern in patterns.items():
            if any(p in name for p in ((pattern,) if isinstance(pattern, str) else pattern)):
                out[key] += ms / iters
    return out


# the two passes of `csrc/attn_bwd.cuh` (K9, K11) and K2a's two kernels (its
# projection: float32 `proj_nt_kernel`, bf16 `gemm_tile.cuh`'s product; then
# the attention of both regions), by profiler name
BWD_PASSES = {"dq_pass": "attn_bwd::dq_", "dkv_pass": "attn_bwd::dkv_"}
K2A_PARTS = {"proj": ("proj_nt", "gemm::"), "attn": "attn"}


def bwd_products(dims) -> dict:
    """The launch sequences of K8 (`csrc/mlp_ln_bwd.cu`) and K7
    (`csrc/feat_attn_bwd.cu`; K7s launches the same) at ``dims`` (FT_DIMS'
    layout): per kernel its ``buffers`` {name: (shape, dtype)}, dtype "cd"
    (the compute dtype) or "f32", the allocations of `ops/fused.py` plus the
    weights and the weight gradients' slabs (views of ``work``); and its
    ``launches`` in order, each {name, reads, writes} and, for a product of
    `gemm_tile.cuh` (C = op(A)·op(B)), its M, N, K, a_t, b_t and operand
    buffers a, b."""
    b, t, S, _, e, h, d, nhid = dims
    R, hd = b * t * S, h * d
    slabs = max(1, -(-R // 2048))

    def prod(name, a, bb, M, N, K, reads, writes, a_t=False, b_t=False):
        return dict(name=name, a=a, b=bb, M=M, N=N, K=K, a_t=a_t, b_t=b_t, reads=reads,
                    writes=writes)

    def rows(name, reads, writes):
        return dict(name=name, reads=reads, writes=writes)

    k8 = {
        "buffers": {
            "x": ((R, e), "cd"), "g": ((R, e), "cd"), "w1": ((e, nhid), "cd"),
            "w2": ((nhid, e), "cd"), "gz": ((R, nhid), "cd"), "gzg": ((R, nhid), "f32"),
            "u": ((R, e), "f32"), "du": ((R, e), "f32"), "du_c": ((R, e), "cd"),
            "dz": ((R, nhid), "cd"), "dx": ((R, e), "cd"), "dw1": ((e, nhid), "f32"),
            "dw2": ((nhid, e), "f32"), "work": ((slabs, e, nhid), "f32"),
            "slabs_dw1": ((slabs, e, nhid), "f32"), "slabs_dw2": ((slabs, nhid, e), "f32"),
        },
        "launches": [
            prod("z=x.W1", "x", "w1", R, nhid, e, ["x", "w1"], ["gz", "gzg"]),
            prod("u=x+gz.W2", "gz", "w2", R, e, nhid, ["gz", "w2", "x"], ["u"]),
            rows("ln_bwd", ["u", "g"], ["du", "du_c"]),
            prod("dz=du.W2t*gelu'", "du_c", "w2", R, nhid, e, ["du_c", "w2", "gzg"], ["dz"],
                 b_t=True),
            prod("dx=du+dz.W1t", "dz", "w1", R, e, nhid, ["dz", "w1", "du"], ["dx"], b_t=True),
            prod("dW1=xt.dz", "x", "dz", e, nhid, R, ["x", "dz"], ["slabs_dw1"], a_t=True),
            rows("sum_slabs dW1", ["slabs_dw1"], ["dw1"]),
            prod("dW2=gzt.du", "gz", "du_c", nhid, e, R, ["gz", "du_c"], ["slabs_dw2"], a_t=True),
            rows("sum_slabs dW2", ["slabs_dw2"], ["dw2"]),
        ],
    }
    k7 = {
        "buffers": {
            "x": ((R, e), "cd"), "g": ((R, e), "cd"), "wqkv": ((3 * hd, e), "cd"),
            "wout": ((hd, e), "cd"), "qkv": ((R, 3 * hd), "cd"), "o": ((R, hd), "cd"),
            "u": ((R, e), "f32"), "du": ((R, e), "f32"), "du_c": ((R, e), "cd"),
            "do": ((R, hd), "cd"), "dqkv": ((R, 3 * hd), "cd"), "dx": ((R, e), "cd"),
            "dwqkv": ((3 * hd, e), "f32"), "dwout": ((hd, e), "f32"),
            "work": ((slabs, 3 * hd, e), "f32"),
            "slabs_dwqkv": ((slabs, 3 * hd, e), "f32"), "slabs_dwout": ((slabs, hd, e), "f32"),
        },
        "launches": [
            prod("qkv=x.Wqkvt", "x", "wqkv", R, 3 * hd, e, ["x", "wqkv"], ["qkv"], b_t=True),
            rows("attn_o", ["qkv"], ["o"]),
            prod("u=x+o.Wout", "o", "wout", R, e, hd, ["o", "wout", "x"], ["u"]),
            rows("ln_bwd", ["u", "g"], ["du", "du_c"]),
            prod("do=du.Woutt", "du_c", "wout", R, hd, e, ["du_c", "wout"], ["do"], b_t=True),
            rows("attn_bwd (softmax backward)", ["qkv", "do"], ["dqkv"]),
            prod("dx=du+dqkv.Wqkv", "dqkv", "wqkv", R, e, 3 * hd, ["dqkv", "wqkv", "du"], ["dx"]),
            prod("dWqkv=dqkvt.x", "dqkv", "x", 3 * hd, e, R, ["dqkv", "x"], ["slabs_dwqkv"],
                 a_t=True),
            rows("sum_slabs dWqkv", ["slabs_dwqkv"], ["dwqkv"]),
            prod("dWout=ot.du", "o", "du_c", hd, e, R, ["o", "du_c"], ["slabs_dwout"], a_t=True),
            rows("sum_slabs dWout", ["slabs_dwout"], ["dwout"]),
        ],
    }
    return {"K8": k8, "K7": k7}


def launch_bytes(seq: dict, launch: dict, es: int) -> int:
    """Bytes a launch of ``seq`` must move: each buffer it reads read once,
    each it writes written once (``es`` bytes an element of the compute
    dtype)."""
    import math

    return sum(math.prod(seq["buffers"][n][0]) * (es if seq["buffers"][n][1] == "cd" else 4)
               for n in launch["reads"] + launch["writes"])


def bwd_flops(dims) -> dict:
    """FLOPs of phase 8's work for K8 (six products of 2·e·nhid a row) and
    K7's products (twelve of 2·e·h·d a token: the QKV and out-projection
    recomputed, do, dx, dW_qkv, dW_out)."""
    b, t, S, _, e, h, d, nhid = dims
    R = b * t * S
    return {"K8": 12 * R * e * nhid, "K7": 2 * R * e * h * d * 12}


# the kernels of K7's and K8's launch sequences, by profiler name
SEQ_KERNELS = ("gemm::", "ln_bwd_kernel", "attn_o_kernel", "attn_bwd_kernel", "row_wg::attn_wg_kernel",
               "sum_slabs_kernel")


def sequence_ms(fn, device, iters: int, names: list) -> dict | None:
    """Device ms per call of each launch of ``fn``'s launch sequence, by
    position: the profiler's kernels whose names hold one of `SEQ_KERNELS`
    (weight casts and copies left out), in start order, ``len(names)`` a
    call; {name: (ms, profiler name)}, or None off the card or where the
    count does not match."""
    import torch

    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = sorted((ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and any(k in ev.name for k in SEQ_KERNELS)),
                 key=lambda ev: ev.time_range.start)
    if len(evs) != iters * len(names):
        print(f"  launch sequence: {len(evs)} kernels in {iters} calls, expected "
              f"{iters * len(names)}: not split", flush=True)
        return None
    out = {}
    for i, name in enumerate(names):
        mine = evs[i::len(names)]
        out[name] = (sum(ev.time_range.elapsed_us() for ev in mine) / 1e3 / iters, mine[0].name)
    return out


def matmul_ms(seq: dict, device, iters: int) -> dict:
    """``torch.matmul`` of bf16 operands of each product's shapes and
    storage orders (A (M, K) or stored (K, M); B (K, N) or stored (N, K)):
    the product alone, with no epilogue. Timed here, used nowhere in the
    port."""
    import torch

    out = {}
    for ln in seq["launches"]:
        if "M" not in ln:
            continue
        M, N, K = ln["M"], ln["N"], ln["K"]
        a = torch.randn((K, M) if ln["a_t"] else (M, K), device=device, dtype=torch.bfloat16)
        bb = torch.randn((N, K) if ln["b_t"] else (K, N), device=device, dtype=torch.bfloat16)
        a, bb = (a.t() if ln["a_t"] else a), (bb.t() if ln["b_t"] else bb)
        out[ln["name"]] = timed(lambda: torch.matmul(a, bb), device, iters)
        del a, bb
    return out


def exact_grid(a, step: float = 0.25, lim: int = 8):
    """``a`` rounded to multiples of ``step`` within ±lim·step: bf16 holds
    such values exactly, and at e = 192 every partial sum of x·W over x on
    the default grid and W on a grid of 1/256 within ±0.375 is a multiple of
    1/1024 below 2^17 of them, exact in float32 in any order."""
    return (a / step).round().clamp(-lim, lim) * step


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


def write_model(path: Path, multiquery: bool = True) -> None:
    """The served model: the published architecture with MGM+CAP 16/8, random
    weights from seed 0, densified from seed 1, as an ``.npz``; with
    ``multiquery=False`` the same weights without the multiquery test block
    (``multiquery_item_attention_for_test_set: false``)."""
    import dataclasses

    from multimodalpfn_tpu_torch.models.loading import load_model, save_npz

    loaded = load_model("random:0", mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8)
    densify(loaded.params, seed=1)
    path.parent.mkdir(parents=True, exist_ok=True)
    cfg = dataclasses.replace(loaded.config, multiquery_item_attention_for_test_set=multiquery)
    save_npz(path, loaded.params, cfg)


def phase_kernels(device, dims, iters, ft_dims, only=None) -> dict:
    """Every kernel against its plain version on the same inputs (with
    ``only``, the cases whose ids start with one of its entries). K4 also
    runs at the flash fine-tune's three blocks (``ft_dims``, as `FT_DIMS`)."""
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
    # the flash fine-tune's blocks: train rows of every head, the test rows
    # of every head, and the test rows folded against KV head 0
    _, ft_t, ft_S, ft_sep, _, ft_h, _, _ = ft_dims
    ft_G, ft_test = ft_t * ft_h, ft_S - ft_sep
    kf, vf = rand(ft_G, ft_sep, d), rand(ft_G, ft_sep, d)
    ft_blocks = {"K4@ft_train": (rand(ft_G, ft_sep, d), kf, vf),
                 "K4@ft_test": (rand(ft_G, ft_test, d), kf, vf),
                 "K4@ft_folded": (rand(ft_t, ft_h * ft_test, d), kf[:ft_t], vf[:ft_t])}
    xp48 = rand(b, n_pred, 48, e)  # K6b at the merged predict shape
    x_ft = rand(1, ft_t, ft_S, e)  # K1, K2a, K2b and K3 at the fine-tune episode
    o_ft = rand(ft_t, ft_S, hd)  # K2b's attention output there
    # the merged group's key masks: each member's own feature tokens, none of
    # its padded ones, the image tokens and the target
    widths = [MERGE_WIDTHS[i % len(MERGE_WIDTHS)] for i in range(b)]
    g_max = 48 - N_IMG_TOKENS - 1
    mask = torch.ones((b, 48), dtype=torch.bool)
    for i, w in enumerate(widths):
        mask[i, w:g_max] = False
    keys = [w + N_IMG_TOKENS + 1 for w in widths]  # valid keys per member

    def feat_work(rows, tt, valid=None, members=b):
        """K1 / K5 (K6a / K6b): projections and out-projection of every token,
        attention of every query against the valid keys of its row; ``rows``
        split evenly over ``members`` members (``valid``: each one's keys)."""
        mask_bytes = 0 if valid is None else 8 * members  # a 64-bit word per member
        valid = [tt] * members if valid is None else valid
        attn = sum(4 * (rows // members) * h * tt * kv * d for kv in valid)
        return lambda es: (2 * rows * tt * 4 * hd * e + attn,
                           2 * rows * tt * e * es + 4 * hd * e * es + mask_bytes)

    def flash_work(G, Sq, Skv):
        return lambda es: (4 * G * Sq * Skv * d, (G * Sq + 2 * G * Skv) * d * es + G * Sq * (d + 1) * 4)

    def sdpa(q, k, v):  # (G, S, d) -> one call with the G groups as heads
        return lambda: F.scaled_dot_product_attention(q[None], k[None], v[None])

    def item_sdpa(x3, sep_):
        """K2a's attention core on x3 ``(G, S, e)`` as PyTorch calls: the
        projection is done before timing, then one call per block (train
        rows on every head, test rows on KV head 0)."""
        def make(dt):
            G_, S_, _ = x3.shape
            w2_ = w_qkv.reshape(3 * hd, e).to(dt)
            qkv = (x3.to(dt) @ w2_.T).reshape(G_, S_, 3, h, d).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1][:, :, :sep_], qkv[2][:, :, :sep_]
            k0, v0 = k[:, :1].expand_as(k), v[:, :1].expand_as(v)

            def run():
                F.scaled_dot_product_attention(q[:, :, :sep_], k, v)
                F.scaled_dot_product_attention(q[:, :, sep_:], k0, v0)
            return run
        return make

    def k2a_work(G, S_, sep_):
        """The projection of every row, the attention of every row against
        the train keys."""
        return lambda es: (2 * G * S_ * e * 3 * hd + 4 * G * h * S_ * sep_ * d,
                           (G * S_ * e + 3 * hd * e + G * S_ * hd) * es + G * h * S_ * 4)

    def k2b_work(G, S_):
        return lambda es: (2 * G * S_ * hd * e, (G * S_ * (2 * e + hd) + hd * e) * es)

    G2, R = b * t, b * S
    cases = {
        "K1": (fused.fused_feature_attention_ln_im, fused.feature_attention_ln_im_plain,
               lambda dt: (x.to(dt), w_qkv, w_out), feat_work(R, t), None),
        "K1@t48": (fused.fused_feature_attention_ln_im, fused.feature_attention_ln_im_plain,
                   lambda dt: (x48.to(dt), w_qkv, w_out), feat_work(R, 48), None),
        "K1@ft": (fused.fused_feature_attention_ln_im, fused.feature_attention_ln_im_plain,
                  lambda dt: (x_ft.to(dt), w_qkv, w_out), feat_work(ft_S, ft_t, members=1), None),
        "K2a": (item_fused.item_attention_core, item_fused.item_attention_core_plain,
                lambda dt: (x.reshape(G2, S, e).to(dt), w_qkv, sep), k2a_work(G2, S, sep),
                item_sdpa(x.reshape(G2, S, e), sep)),
        "K2b": (item_fused.item_epilogue_ln, item_fused.item_epilogue_ln_plain,
                lambda dt: (x.reshape(G2, S, e).to(dt), o_in.to(dt), w_out), k2b_work(G2, S),
                None),
        # the fused-path fine-tune's episode: 30 groups of 1655 train + 183 test rows
        "K2a@ft": (item_fused.item_attention_core, item_fused.item_attention_core_plain,
                   lambda dt: (x_ft.reshape(ft_t, ft_S, e).to(dt), w_qkv, ft_sep),
                   k2a_work(ft_t, ft_S, ft_sep), item_sdpa(x_ft.reshape(ft_t, ft_S, e), ft_sep)),
        "K2b@ft": (item_fused.item_epilogue_ln, item_fused.item_epilogue_ln_plain,
                   lambda dt: (x_ft.reshape(ft_t, ft_S, e).to(dt), o_ft.to(dt), w_out),
                   k2b_work(ft_t, ft_S), None),

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
    # K3 where it serves and trains: fit_preprocessors, the KV-cache prime
    # and predict (the merged group of 48 tokens), the fine-tune episode
    for kid, xk in {"K3": x, "K3@prime": xs48.reshape(b * sep, 48, e),
                    "K3@predict": xp48.reshape(b * n_pred, 48, e), "K3@ft": x_ft}.items():
        rows_k = xk.numel() // e
        cases[kid] = (fused.fused_mlp_ln, fused.mlp_ln_plain, lambda dt, xk=xk: (xk.to(dt), w1, w2),
                      lambda es, n=rows_k: (4 * n * e * nhid, (2 * n * e + 2 * e * nhid) * es), None)
    for kid, (qb, kb, vb) in ft_blocks.items():
        cases[kid] = (flash.flash_attention, flash.flash_attention_plain,
                      lambda dt, qkv=(qb, kb, vb): tuple(a.to(dt) for a in qkv),
                      flash_work(qb.shape[0], qb.shape[1], kb.shape[1]),
                      lambda dt, qkv=(qb, kb, vb): sdpa(*(a.to(dt) for a in qkv)))
    if only is not None:
        cases = {kid: case for kid, case in cases.items() if kid.startswith(tuple(only))}
    # the (query, key) pairs each attention forward exponentiates once: K2a's
    # train rows (every head) and test rows (KV head 0) against the train keys
    pairs = {"K2a": G2 * h * S * sep, "K2a@ft": ft_t * h * ft_S * ft_sep} | {
        kid: (lambda a: a[0].shape[0] * a[0].shape[1] * a[1].shape[1])(make(torch.float32))
        for kid, (_, _, make, _, _) in cases.items() if kid.startswith("K4")}
    results = {}
    for kid, (kern, plain, make, work, library) in cases.items():
        res = {"shape": list(make(torch.float32)[0].shape)}
        for dt, tag, rel_bound in (
            (torch.float32, "f32", F32_REL_BOUND),
            (torch.bfloat16, "bf16", BF16_REL_BOUND),
        ):
            args = make(dt)
            got, want = kern(*args), plain(*args)
            if kid.startswith(("K1", "K2b", "K3", "K5", "K6")):  # a repeat gives the same bits
                res[f"repeat_bit_equal_{tag}"] = bool(torch.equal(got, kern(*args)))
                check(res[f"repeat_bit_equal_{tag}"], f"{kid} {tag}: two runs on the same inputs differ")
            if isinstance(got, tuple):  # (o, lse)
                (got, got_lse), (want, want_lse) = got, want
                lse_err = float((got_lse - want_lse).abs().max())
                res[f"lse_max_abs_err_{tag}"] = lse_err
                if kid.startswith("K2a") and tag == "bf16":
                    # K2a's projection and the plain version's sum in other
                    # orders, so a q or k element may round to its bf16
                    # neighbour and shift a score (lse_max_abs_err_bf16);
                    # on inputs whose sums are exact the two round alike,
                    # and the lse holds the attention alone
                    exact = (exact_grid(args[0]), exact_grid(args[1], 1 / 256, 96), args[2])
                    lse_err = float((kern(*exact)[1] - plain(*exact)[1]).abs().max())
                    res["lse_exact_proj_max_abs_err_bf16"] = lse_err
                check(lse_err <= LSE_ABS_BOUND, f"{kid} {tag} lse err {lse_err:.3e} > {LSE_ABS_BOUND:.0e}")
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
            es = 2 if tag == "bf16" else 4
            flops, nbytes = work(es)
            res[f"bound_ms_{tag}"], res[f"bound_by_{tag}"] = bound(flops, nbytes, tag)
            res[f"library_ms_{tag}"] = None
            if library is not None and tag == "bf16":
                res[f"library_ms_{tag}"] = timed(library(dt), device, iters)
            lib = res[f"library_ms_{tag}"]
            extra = ""
            if kid.startswith("K2a"):  # the projection and the attention apart
                for part, ms in profiled_ms(lambda: kern(*args), device, iters, K2A_PARTS).items():
                    res[f"{part}_ms_{tag}"] = ms
                    extra += f", {part} {ms:.3f} ms"
                # the projection's own bound: x and W_qkv read, qkv written once
                G_, S_, _ = args[0].shape
                res[f"proj_bound_ms_{tag}"], by = bound(
                    2 * G_ * S_ * e * 3 * hd, (G_ * S_ * e + 3 * hd * e + G_ * S_ * 3 * hd) * es, tag)
                extra += f", projection bound {res[f'proj_bound_ms_{tag}']:.3f} ms ({by})"
            if kid.startswith("K3") and tag == "bf16" and device.type == "cuda":
                # K3's two products alone, as torch.matmul calls (two calls,
                # so not a library_ms): x·W1, then the bf16 hidden layer·W2
                x2 = args[0].reshape(-1, e)
                w1b, w2b = w1.to(dt), w2.to(dt)
                hid = torch.randn((x2.shape[0], nhid), device=device, dtype=dt)
                res["matmul_ms_bf16"] = (timed(lambda: torch.matmul(x2, w1b), device, iters)
                                         + timed(lambda: torch.matmul(hid, w2b), device, iters))
                extra += f", torch.matmul on its two products {res['matmul_ms_bf16']:.3f} ms"
                del hid
            if kid.startswith(("K2a", "K2b")) and tag == "bf16" and device.type == "cuda":
                # K2a's projection (x·W_qkv^T, the product that K9 shares)
                # or K2b's out-projection (o·W_out) alone, as one
                # torch.matmul call: neither is the kernel's whole function
                a2 = args[0].reshape(-1, e) if kid.startswith("K2a") else args[1].reshape(-1, hd)
                wm = (w_qkv.reshape(3 * hd, e).to(dt).t() if kid.startswith("K2a")
                      else w_out.reshape(hd, e).to(dt))
                res["matmul_ms_bf16"] = timed(lambda: torch.matmul(a2, wm), device, iters)
                extra += (f", torch.matmul on its {'projection' if kid.startswith('K2a') else 'out-product'}"
                          f" {res['matmul_ms_bf16']:.3f} ms")
            if kid.startswith(("K1", "K5", "K6")) and tag == "bf16" and device.type == "cuda":
                # the QKV and out-projections alone, as torch.matmul calls:
                # every token row·W_qkv^T, then the bf16 head outputs·W_out
                x2 = args[0].reshape(-1, e)
                wq, wo = w_qkv.reshape(3 * hd, e).to(dt).t(), w_out.reshape(hd, e).to(dt)
                o2 = torch.randn((x2.shape[0], hd), device=device, dtype=dt)
                res["matmul_ms_bf16"] = (timed(lambda: torch.matmul(x2, wq), device, iters)
                                         + timed(lambda: torch.matmul(o2, wo), device, iters))
                extra += f", torch.matmul on its two projections {res['matmul_ms_bf16']:.3f} ms"
                del o2
            if kid in pairs:
                # computed, not measured: printed here, kept out of the kernels line
                floor = exp_floor_ms(pairs[kid], device)
                if floor is not None:
                    extra += f", exp floor {floor:.3f} ms"
            if "lse_max_abs_err_" + tag in res:
                extra += f", lse max abs err {res['lse_max_abs_err_' + tag]:.2e}"
            print(
                f"  {kid} {tag}: max abs err {err:.3e}, rel err {rel:.3e} (bound {rel_bound:.3e}), "
                f"kernel {res[f'ms_{tag}']:.3f} ms, plain {res[f'plain_ms_{tag}']:.3f} ms, "
                f"bound {res[f'bound_ms_{tag}']:.3f} ms ({res[f'bound_by_{tag}']})" + extra
                + ("" if tag == "f32" else ", no single library call" if lib is None
                   else f", library {lib:.3f} ms"),
                flush=True,
            )
            if kid.startswith("K2a") and lib is not None and res.get(f"attn_ms_{tag}"):
                print(f"  {kid} {tag}: its attention against the library's attention core: "
                      f"{res[f'attn_ms_{tag}'] / lib:.2f}x", flush=True)
            check(finite, f"{kid} {tag}: non-finite output")
            check(rel <= rel_bound, f"{kid} {tag}: rel err {rel:.3e} > {rel_bound:.3e}")
        results[kid] = res
    return results


def phase_bwd_kernels(device, dims, iters, only=None) -> dict:
    """The backward kernels K7-K10, K7s and K11 against their plain versions
    on the same inputs, at the fine-tune shapes, in float32 and bf16. Each
    output (dx, each dW, K10's du, do and delta, K11's dq, dk, dv) is held
    relative to its own largest magnitude; each kernel runs twice on the same
    inputs, and the two results must be the same bits (the weight gradients
    are summed in a fixed order, and no kernel uses atomics). K11 runs at the
    flash path's three blocks: the train block (every head), the test block
    unfolded (no multiquery) and folded (the heads against KV head 0). For
    K7 and K8 in bf16 it also times each launch of their sequence by
    profiler name (`sequence_ms`), each product beside ``torch.matmul`` on
    operands of its shapes, and the sequence's bytes over the HBM rate
    (`bwd_products`). ``only`` restricts the kernels run."""
    import torch
    import torch.nn.functional as F

    from multimodalpfn_tpu_torch.ops import flash, fused, item_fused

    b, t, S, sep, e, h, d, nhid = dims
    hd, G, R = h * d, b * t, b * t * S
    gen = torch.Generator().manual_seed(2)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    x, g = rand(b, t, S, e), rand(b, t, S, e)
    w_qkv = rand(3, h, d, e, scale=(2.0 / (h * d + e)) ** 0.5)
    w_out = rand(h, d, e, scale=(h * d) ** -0.5)
    w1, w2 = rand(e, nhid, scale=e**-0.5), rand(nhid, e, scale=nhid**-0.5)
    item = {}

    def item_inputs(dt):
        """The item sublayer's saved forward (o, lse) and K10's plain outputs
        (du, do, delta), which K9 consumes."""
        if dt not in item:
            x3, g3 = x.reshape(G, S, e).to(dt), g.reshape(G, S, e).to(dt)
            o, lse = item_fused.item_attention_core_plain(x3, w_qkv, sep)
            du, do, delta, _ = item_fused.item_epilogue_bwd_plain(x3, o, w_out, g3)
            item[dt] = dict(x3=x3, g3=g3, o=o, lse=lse, du=du, do=do, delta=delta)
        return item[dt]

    def item_sdpa_bwd(dt):
        """K9's attention-core backward as PyTorch calls: SDPA over the self
        region (every head) and the cross region (KV head 0 expanded), the
        projection done before timing; the timed call is the backward."""
        a = item_inputs(dt)
        qkv = (a["x3"] @ w_qkv.reshape(3 * hd, e).to(dt).T).reshape(G, S, 3, h, d).permute(2, 0, 3, 1, 4)

        def leaf(t_):
            return t_.detach().contiguous().requires_grad_(True)

        q, k, v = leaf(qkv[0]), leaf(qkv[1][:, :, :sep]), leaf(qkv[2][:, :, :sep])
        k0, v0 = leaf(qkv[1][:, :1, :sep]), leaf(qkv[2][:, :1, :sep])
        dog = a["do"].reshape(G, S, h, d).transpose(1, 2)
        with torch.enable_grad():
            outs = [F.scaled_dot_product_attention(q[:, :, :sep], k, v)]
            cots = [dog[:, :, :sep]]
            if S > sep:
                outs.append(F.scaled_dot_product_attention(
                    q[:, :, sep:], k0.expand(-1, h, -1, -1), v0.expand(-1, h, -1, -1)))
                cots.append(dog[:, :, sep:])
        return lambda: torch.autograd.grad(outs, (q, k, v, k0, v0), cots, retain_graph=True,
                                           allow_unused=True)

    flash_in = {}

    def flash_inputs(G_, Sq, dt):
        """K11's operands at one block: q, k, v in the compute dtype, K4's
        float32 o and lse, and a float32 cotangent of o."""
        key = (G_, Sq, dt)
        if key not in flash_in:
            q, k, v = rand(G_, Sq, d).to(dt), rand(G_, sep, d).to(dt), rand(G_, sep, d).to(dt)
            with torch.no_grad():
                o, lse = flash.flash_attention(q, k, v)
            flash_in[key] = (q, k, v, o, lse, rand(G_, Sq, d))
        return flash_in[key]

    def flash_work(G_, Sq):
        """Five products of 2·d FLOPs per (query, key) pair; q, k, v and dq,
        dk, dv in the compute dtype, o, do (float32) and lse read once."""
        return lambda es: (10 * d * G_ * Sq * sep,
                           2 * (G_ * Sq + 2 * G_ * sep) * d * es + G_ * Sq * (2 * d + 1) * 4)

    def flash_sdpa_bwd(G_, Sq):
        """K11's yardstick: the backward of one SDPA call over the same bf16
        q, k, v (the G groups as heads), forward done before timing."""
        def make(dt):
            q, k, v, _, _, do = flash_inputs(G_, Sq, dt)
            leaves = [a.detach().clone().requires_grad_(True) for a in (q, k, v)]
            with torch.enable_grad():
                out = F.scaled_dot_product_attention(*(a[None] for a in leaves))
            cot = do.to(dt)[None]
            return lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)
        return make

    hS = S - sep
    blocks = {"K11": (G * h, sep), "K11@test": (G * h, hS), "K11@folded": (G, h * hS)}
    # the (query, key) pairs each pass of K9 and K11 exponentiates: K9's
    # self region (every head) and cross region (test rows of every head
    # against KV head 0's train keys); K11's block
    pairs = {"K9": G * h * (sep * sep + hS * sep)} | {kid: G_ * Sq * sep for kid, (G_, Sq) in blocks.items()}
    # FLOPs and bytes of the work itself: each input read once, each output
    # written once; attention FLOPs over the (query, key) pairs of the run
    cases = {
        "K7": (fused.feature_attention_ln_im_bwd, fused.feature_attention_ln_im_bwd_plain,
               lambda dt: (x.to(dt), w_qkv, w_out, g.to(dt)),
               # QKV and out-projection recomputed, do, dx, dW_qkv, dW_out;
               # per row and head: scores, p·v, dp, dq, dk, dv over t × t
               lambda es: (bwd_flops(dims)["K7"] + 12 * b * S * h * t * t * d,
                           3 * R * e * es + 4 * hd * e * (es + 4))),
        "K8": (fused.mlp_ln_bwd, fused.mlp_ln_bwd_plain,
               lambda dt: (x.to(dt), w1, w2, g.to(dt)),
               lambda es: (bwd_flops(dims)["K8"], 3 * R * e * es + 2 * e * nhid * (es + 4))),
        "K10": (item_fused.item_epilogue_bwd, item_fused.item_epilogue_bwd_plain,
                lambda dt: (lambda a: (a["x3"], a["o"], w_out, a["g3"]))(item_inputs(dt)),
                lambda es: (6 * R * hd * e + 2 * R * hd,
                            R * (3 * e + 2 * hd) * es + G * h * S * 4 + hd * e * (es + 4))),
        "K9": (item_fused.item_attention_bwd, item_fused.item_attention_bwd_plain,
               lambda dt: (lambda a: (a["x3"], w_qkv, a["do"], a["delta"], a["lse"], sep, a["du"]))(
                   item_inputs(dt)),
               # Q recomputed on every row, K and V on the train rows only (test
               # rows are never keys); dx and dW from dq on every row, from
               # dk, dv on the train rows (the cross region's head-0 dk, dv
               # folded into head 0); scores, dp, dq, dk, dv per pair
               lambda es: (2 * R * e * hd + 2 * G * sep * e * 2 * hd + 4 * R * hd * e
                           + 4 * G * sep * 2 * hd * e + 10 * d * G * h * sep * S,
                           R * (3 * e + hd) * es + 2 * G * h * S * 4 + 3 * hd * e * (es + 4))),
        # the sample-major layout of K7's work: the episode's rows (b, S, t, e)
        "K7s": (fused.feature_attention_ln_bwd, fused.feature_attention_ln_bwd_plain,
                lambda dt: (x.transpose(1, 2).contiguous().to(dt), w_qkv, w_out,
                            g.transpose(1, 2).contiguous().to(dt)),
                lambda es: (2 * R * e * hd * 12 + 12 * b * S * h * t * t * d,
                            3 * R * e * es + 4 * hd * e * (es + 4))),
    }
    for kid, (G_, Sq) in blocks.items():
        cases[kid] = (flash.flash_attention_bwd, flash.flash_attention_bwd_plain,
                      lambda dt, G_=G_, Sq=Sq: flash_inputs(G_, Sq, dt), flash_work(G_, Sq))
    libraries = {"K9": item_sdpa_bwd} | {kid: flash_sdpa_bwd(*blk) for kid, blk in blocks.items()}
    seqs = bwd_products(dims)
    seqs["K7s"] = seqs["K7"]
    results = {}
    for kid, (kern, plain, make, work) in cases.items():
        if only is not None and kid not in only:
            continue
        res = {"shape": list(make(torch.float32)[0].shape)}
        for dt, tag, rel_bound in (
            (torch.float32, "f32", F32_REL_BOUND),
            (torch.bfloat16, "bf16", BF16_REL_BOUND),
        ):
            args = make(dt)
            got, again, want = kern(*args), kern(*args), plain(*args)
            if device.type == "cuda":
                torch.cuda.synchronize()
            errs = [float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)]
            rels = [err / max(float(w.float().abs().max()), 1e-30) for err, w in zip(errs, want)]
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
            del got, again, want
            res[f"max_abs_err_{tag}"] = max(errs)
            res[f"rel_err_{tag}"] = max(rels)
            res[f"repeat_bit_equal_{tag}"] = same
            res[f"ms_{tag}"] = timed(lambda: kern(*args), device, iters)
            res[f"plain_ms_{tag}"] = timed(lambda: plain(*args), device, max(1, iters // 2))
            flops, nbytes = work(2 if tag == "bf16" else 4)
            res[f"bound_ms_{tag}"], res[f"bound_by_{tag}"] = bound(flops, nbytes, tag)
            res[f"library_ms_{tag}"] = None
            if kid in libraries and tag == "bf16":
                res[f"library_ms_{tag}"] = timed(libraries[kid](dt), device, iters)
            lib = res[f"library_ms_{tag}"]
            passes = ""
            if kid in pairs:
                for name, ms in profiled_ms(lambda: kern(*args), device, iters, BWD_PASSES).items():
                    res[f"{name}_ms_{tag}"] = ms
                    passes += f", {name} {ms:.3f} ms"
                # computed, not measured: printed here, kept out of the kernels line
                floor = exp_floor_ms(2 * pairs[kid], device)
                if floor is not None:
                    passes += f", exp floor {floor:.3f} ms"
            print(
                f"  {kid} {tag}: rel errs {', '.join(f'{r:.2e}' for r in rels)} (bound "
                f"{rel_bound:.3e}), max abs err {max(errs):.3e}, repeat bit-equal {same}, "
                f"kernel {res[f'ms_{tag}']:.3f} ms, plain {res[f'plain_ms_{tag}']:.3f} ms, "
                f"bound {res[f'bound_ms_{tag}']:.3f} ms ({res[f'bound_by_{tag}']})" + passes
                + ("" if tag == "f32" else ", no single library call" if lib is None
                   else f", library (SDPA backward) {lib:.3f} ms"),
                flush=True,
            )
            if kid in seqs and tag == "bf16":
                res |= launch_sequence(kid, seqs[kid], lambda: kern(*args), device, iters,
                                       dims if kid in ("K7", "K7s") else None)
            check(finite, f"{kid} {tag}: non-finite output")
            check(same, f"{kid} {tag}: two runs on the same inputs differ")
            check(max(rels) <= rel_bound, f"{kid} {tag}: rel err {max(rels):.3e} > {rel_bound:.3e}")
        results[kid] = res
        flash_in.clear()
    return results


# K7's per-row attention launches (`bwd_products`): the forward (o) and the
# softmax backward (dq, dk, dv), each one pass over the (query, key) pairs
ROW_ATTN = {"attn_o": False, "attn_bwd (softmax backward)": True}


def row_attn_sdpa_ms(dims, device, iters) -> dict:
    """The yardstick of K7's per-row attention, never called by the port:
    ``scaled_dot_product_attention`` on random bf16 q, k, v of the
    episode's rows as (rows·h, t, d), forward, and its backward (the
    forward done before timing), in ms."""
    import torch
    import torch.nn.functional as F

    if device.type != "cuda":
        return {}
    b, t, S, _, _, h, d, _ = dims
    q, k, v = (torch.randn((b * S * h, t, d), device=device, dtype=torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    do = torch.randn((b * S * h, t, d), device=device, dtype=torch.bfloat16)
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(q, k, v)
    qc, kc, vc = q.detach(), k.detach(), v.detach()
    fwd = timed(lambda: F.scaled_dot_product_attention(qc, kc, vc), device, iters)
    bwd = timed(lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True), device, iters)
    return {"attn_o": fwd, "attn_bwd (softmax backward)": bwd}


def launch_sequence(kid, seq, fn, device, iters, attn_dims=None) -> dict:
    """K7's, K7s' or K8's bf16 launch sequence: each launch's device time by
    profiler name, each product's ``torch.matmul`` time, each launch's bytes
    over the HBM rate, all printed; the two measured ones are returned as
    ``products_ms`` and ``matmul_ms`` (each {launch: ms}). With
    ``attn_dims`` (K7, K7s: the episode, `FT_DIMS`' layout) the per-row
    attention launches also print their exponential floor (one ex2 per
    (query, key) pair of a sample, a pass) and SDPA's time on the same
    shapes (`row_attn_sdpa_ms`), returned as ``attn_sdpa_ms``. The bounds
    and floors are computed, not measured, so they stay out of the
    ``kernels`` line."""
    per = {ln["name"]: launch_bytes(seq, ln, 2) / HBM_BYTES_PER_S * 1e3 for ln in seq["launches"]}
    per["total"] = sum(per.values())
    got = sequence_ms(fn, device, iters, [ln["name"] for ln in seq["launches"]])
    mm = matmul_ms(seq, device, iters) if device.type == "cuda" else {}
    sdpa, floor = {}, None
    if attn_dims is not None:
        b, t, S, _, _, h, _, _ = attn_dims
        sdpa = row_attn_sdpa_ms(attn_dims, device, iters)
        floor = exp_floor_ms(b * S * h * t * t, device)
    for ln in seq["launches"]:
        name = ln["name"]
        ms, prof_name = got[name] if got else (None, "not measured")
        shape = f" {ln['M']}x{ln['N']}x{ln['K']}" if "M" in ln else ""
        attn = ""
        if name in ROW_ATTN and attn_dims is not None:
            attn = (f", exp floor {'not measured' if floor is None else f'{floor:.4f} ms'}, SDPA"
                    f"{' backward' if ROW_ATTN[name] else ''} "
                    + (f"{sdpa[name]:.4f} ms" if name in sdpa else "not measured"))
        print(f"    {kid} {name}{shape}: "
              + ("not measured" if ms is None else f"{ms:.4f} ms")
              + (f", torch.matmul {mm[name]:.4f} ms" if name in mm else "")
              + f", bytes bound {per[name]:.4f} ms{attn} [{prof_name[:70]}]", flush=True)
    print(f"    {kid} launch sequence: bytes bound {per['total']:.4f} ms"
          + (f", launches {sum(v[0] for v in got.values()):.4f} ms" if got else ""), flush=True)
    return {"products_ms": {k: v[0] for k, v in got.items()} if got else None,
            "matmul_ms": mm or None} | ({"attn_sdpa_ms": sdpa or None} if attn_dims else {})


def f32_fingerprints(device) -> dict:
    """sha256 (first 16 hex digits) of the float32 outputs of K9, K11, K4
    and K2a and of their bf16 outputs at d = 8, of the float32 outputs of
    K7, K7s, K8, K10, K3, K1, K5, K6a, K6b and K2b, of K3's, K5's and K2b's
    bf16 outputs at e = 96 and of K7's and K7s' at d = 8: the work of the
    CUDA-core bodies of
    `csrc/attn_bwd.cuh`, `csrc/attn_tile.cuh`, `csrc/gemm_tile.cuh`
    (cc_kernel), `csrc/mlp_ln.cu`, `csrc/feat_attn.cu` and
    `csrc/item_epilogue.cu`, of K3's and K2b's mma.sync bodies and of the
    backward row kernels, which the bf16 redesigns left as they were. Inputs come from a seeded CPU generator
    and, for the backward kernels, the plain forward and epilogue backward on
    the card (no other kernel of the port, so the digests pin the CUDA-core
    bodies alone); phase 8 holds them equal to `PARENT_F32_SHA256`, the
    parent commits'."""
    import hashlib

    import torch

    from multimodalpfn_tpu_torch.ops import flash, fused, item_fused

    gen = torch.Generator().manual_seed(6)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    def digest(ts) -> str:
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    out = {}
    with torch.no_grad():
        for dt, d in ((torch.float32, 8), (torch.float32, 16), (torch.float32, 32),
                      (torch.float32, 64), (torch.bfloat16, 8)):
            q, k, v = rand(6, 183, d).to(dt), rand(6, 300, d).to(dt), rand(6, 300, d).to(dt)
            o, lse = flash.flash_attention_plain(q, k, v)
            tag = "f32" if dt == torch.float32 else "bf16"
            out[f"K11 {tag} d={d}"] = digest(flash.flash_attention_bwd(q, k, v, o, lse, rand(6, 183, d)))
        for d in (16, 32):
            h, e, S, sep = 6, 96, 300, 237
            x3, g3 = rand(2, S, e), rand(2, S, e)
            w_qkv, w_out = rand(3, h, d, e, scale=e**-0.5), rand(h, d, e, scale=(h * d) ** -0.5)
            o, lse = item_fused.item_attention_core_plain(x3, w_qkv, sep)
            du, do, delta, _ = item_fused.item_epilogue_bwd_plain(x3, o, w_out, g3)
            out[f"K9 f32 d={d}"] = digest(item_fused.item_attention_bwd(x3, w_qkv, do, delta, lse, sep, du))
        # the forward's CUDA-core body (attn::cc_rows): K4 and K2a in float32,
        # and bf16 at d = 8
        for dt, d in ((torch.float32, 8), (torch.float32, 16), (torch.float32, 32),
                      (torch.float32, 64), (torch.bfloat16, 8)):
            tag = "f32" if dt == torch.float32 else "bf16"
            q, k, v = rand(6, 183, d).to(dt), rand(6, 300, d).to(dt), rand(6, 300, d).to(dt)
            out[f"K4 {tag} d={d}"] = digest(flash.flash_attention(q, k, v))
            x3, w_qkv = rand(2, 300, 96).to(dt), rand(3, 6, d, 96, scale=96**-0.5)
            out[f"K2a {tag} d={d}"] = digest(item_fused.item_attention_core(x3, w_qkv, 237))
        # the float32 body of `gemm_tile.cuh` (cc_kernel) with the row kernels
        # of K7, K7s, K8 and K10, over 2400 rows (two weight-gradient slabs)
        e, h, d, nhid = 96, 6, 16, 192
        x, g = rand(1, 8, 300, e), rand(1, 8, 300, e)
        w_qkv, w_out = rand(3, h, d, e, scale=e**-0.5), rand(h, d, e, scale=(h * d) ** -0.5)
        w1, w2 = rand(e, nhid, scale=e**-0.5), rand(nhid, e, scale=nhid**-0.5)
        out["K7 f32"] = digest(fused.feature_attention_ln_im_bwd(x, w_qkv, w_out, g))
        out["K7s f32"] = digest(fused.feature_attention_ln_bwd(
            x.transpose(1, 2).contiguous(), w_qkv, w_out, g.transpose(1, 2).contiguous()))
        out["K8 f32"] = digest(fused.mlp_ln_bwd(x, w1, w2, g))
        x3, g3 = x.reshape(8, 300, e), g.reshape(8, 300, e)
        o, _ = item_fused.item_attention_core_plain(x3, w_qkv, 237)
        out["K10 f32"] = digest(item_fused.item_epilogue_bwd(x3, o, w_out, g3))
        # K3's CUDA-core body in float32 at the published widths, and its
        # mma.sync body (bf16 at e = 96)
        x, w1, w2 = rand(2, 300, 192), rand(192, 768, scale=192**-0.5), rand(768, 192, scale=768**-0.5)
        out["K3 f32"] = digest(fused.fused_mlp_ln(x, w1, w2))
        x, w1, w2 = rand(2, 300, 96), rand(96, 192, scale=96**-0.5), rand(192, 96, scale=192**-0.5)
        out["K3 bf16 e=96"] = digest(fused.fused_mlp_ln(x.to(torch.bfloat16), w1, w2))
        # the CUDA-core body of K1, K5, K6a and K6b (feat_attn_ln_kernel) in
        # float32 at the published widths, with ragged member masks, and in
        # bf16 at e = 96, a width the wgmma body does not take
        e, h, d, t = 192, 6, 32, 31
        w_qkv, w_out = rand(3, h, d, e, scale=e**-0.5), rand(h, d, e, scale=(h * d) ** -0.5)
        x_im, x_sm = rand(2, t, 37, e), rand(2, 37, t, e)
        mask = torch.ones((2, t), dtype=torch.bool)
        mask[1, 9:t - 1] = False
        out["K1 f32"] = digest(fused.fused_feature_attention_ln_im(x_im, w_qkv, w_out))
        out["K5 f32"] = digest(fused.fused_feature_attention_ln(x_sm, w_qkv, w_out, 27))
        out["K6a f32"] = digest(fused.fused_feature_attention_ln_im(x_im, w_qkv, w_out, mask))
        out["K6b f32"] = digest(fused.fused_feature_attention_ln(x_sm, w_qkv, w_out, None, mask[:, None]))
        w_qkv, w_out = rand(3, 6, 16, 96, scale=96**-0.5), rand(6, 16, 96, scale=96**-0.5)
        out["K5 bf16 e=96"] = digest(fused.fused_feature_attention_ln(
            rand(2, 37, t, 96).to(torch.bfloat16), w_qkv, w_out))
        # K2b's CUDA-core body in float32 at the published widths (a ragged
        # last block of 32 rows), and its mma.sync body (bf16 at e = 96)
        x3, o, w_out = rand(2, 300, 192), rand(2, 300, 192), rand(6, 32, 192, scale=192**-0.5)
        out["K2b f32"] = digest(item_fused.item_epilogue_ln(x3, o, w_out))
        x3, o, w_out = rand(2, 300, 96), rand(2, 300, 96), rand(6, 16, 96, scale=96**-0.5)
        out["K2b bf16 e=96"] = digest(item_fused.item_epilogue_ln(
            x3.to(torch.bfloat16), o.to(torch.bfloat16), w_out))
        # K7's and K7s' per-row warp kernels in bf16 at d = 8, the width the
        # wgmma body does not take (with the bf16 product tile around them)
        x, g = rand(1, 8, 300, 96).to(torch.bfloat16), rand(1, 8, 300, 96).to(torch.bfloat16)
        w_qkv, w_out = rand(3, 12, 8, 96, scale=96**-0.5), rand(12, 8, 96, scale=96**-0.5)
        out["K7 bf16 d=8"] = digest(fused.feature_attention_ln_im_bwd(x, w_qkv, w_out, g))
        out["K7s bf16 d=8"] = digest(fused.feature_attention_ln_bwd(
            x.transpose(1, 2).contiguous(), w_qkv, w_out, g.transpose(1, 2).contiguous()))
    return out


def device_kernel_rows(prof) -> list[tuple[float, int, str]]:
    """(device ms, calls, name) of every CUDA kernel in a profile, the
    longest first. A region annotated on the device (``Optimizer.step``) spans
    kernels already counted, so it is left out."""
    import torch

    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if getattr(ev, "is_user_annotation", False):
            continue
        if dt and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dt / 1e3, ev.count, ev.key[:90]))
    return sorted(rows, reverse=True)


def print_profile(tag: str, wall: float, rows, top: int) -> None:
    busy = sum(r[0] for r in rows)
    print(f"  {tag}: wall {wall:.2f} ms, device kernel time {busy:.2f} ms, "
          f"idle share {1 - busy / wall:.3f}", flush=True)
    for ms, count, key in rows[:top]:
        print(f"    {ms:9.3f} ms  x{count:4d}  {key}", flush=True)


def sample_major_grad(device, dims) -> None:
    """One differentiable call of the public sample-major sublayer
    ``fused_feature_attention_ln`` (K5 forward, K7s backward) on x
    ``(b, S, t, e)`` of the fine-tune episode, bf16, with a sum of squares as
    the loss: the entry point through which K7s is reached (the JAX
    package's grad tests call it so; no served or training path does)."""
    import torch

    from multimodalpfn_tpu_torch.ops import fused

    b, t, S, _, e, h, d, _ = dims
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((b, S, t, e), generator=gen).to(device=device, dtype=torch.bfloat16)
    w_qkv = (torch.randn((3, h, d, e), generator=gen) * e**-0.5).to(device).requires_grad_(True)
    w_out = (torch.randn((h, d, e), generator=gen) * (h * d) ** -0.5).to(device).requires_grad_(True)
    x.requires_grad_(True)
    out = fused.fused_feature_attention_ln(x, w_qkv, w_out)
    (out.float() ** 2).sum().backward()
    grads = (x.grad, w_qkv.grad, w_out.grad)
    check(all(gr is not None and bool(torch.isfinite(gr.float()).all()) for gr in grads),
          "the sample-major sublayer's gradients are missing or not finite")
    print(f"  fused_feature_attention_ln differentiated at x {tuple(x.shape)} bf16: dx, dW_qkv, "
          "dW_out finite", flush=True)


def phase_finetune(device, model_path, data, steps, n_layers, out_path, flash_dims=None) -> dict:
    """``fine_tune_mmpfn`` on the flagship in bf16, validation after every
    step, with the launch counters zeroed just before and read just after:
    every training step runs K7, K8, K9 and K10 once per layer. With
    ``flash_dims`` (the episode's dimensions, `FT_DIMS`) the model has no
    multiquery test block, so the K2 gate refuses
    it: every step runs K4 and K11 in both item blocks of every layer (and
    each validation K4 in both), and no K2a, K2b, K9 or K10; before the
    fine-tune, in the same count, the public sample-major sublayer is
    differentiated once (K5, K7s). Then the best snapshot is served by the
    classifier."""
    import numpy as np
    import torch

    from multimodalpfn_tpu_torch.models.loading import load_model, load_npz
    from multimodalpfn_tpu_torch.models.params import flatten_params
    from multimodalpfn_tpu_torch.ops import kernels
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn

    X, img, y = data
    flash = flash_dims is not None
    kernels.reset_launches()
    if flash:
        sample_major_grad(device, flash_dims)
    t0 = time.perf_counter()
    hist = fine_tune_mmpfn(
        mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8, features_per_group=1,
        X_train=X, image_train=img, y_train=y, path_to_base_model=str(model_path),
        save_path_to_fine_tuned_model=str(out_path), finetuning_config={"max_steps": steps},
        device=str(device), random_seed=0,
    )
    wall = time.perf_counter() - t0
    launches, bodies = dict(kernels.LAUNCHES), dict(kernels.BODY_LAUNCHES)
    loss, gn = hist["train_loss"], hist["grad_norm"]
    step_ms = [s * 1e3 for s in hist["step_seconds"]]
    warm = float(np.median(step_ms[1:])) if len(step_ms) > 1 else step_ms[0]
    print(f"  {hist['steps']} steps in {wall:.1f} s: model init {hist['phase_seconds']['model_init'] * 1e3:.1f}"
          f" ms, initial validation {hist['phase_seconds']['initial_validation'] * 1e3:.1f} ms, first "
          f"step {step_ms[0]:.1f} ms, warm median step {warm:.1f} ms (a step with its validation); "
          f"train loss {loss[0]:.5f} -> {loss[-1]:.5f}, grad norm {gn[0]:.4f} -> {gn[-1]:.4f}, "
          f"best validation error {hist['best_val_error']:.5f}, skipped {hist['skipped_steps']}",
          flush=True)
    L = n_layers
    if flash:  # K4: both blocks of every layer in each step and each of steps + 1 validations
        exact = {"K7": L * steps, "K8": L * steps, "K11": 2 * L * steps, "K4": 2 * L * (2 * steps + 1),
                 "K2a": 0, "K2b": 0, "K9": 0, "K10": 0, "K5": 1, "K7s": 1}
        print(f"  launches {launches} (K7, K8 = {L} x {steps}; K11 = 2 x {L} x {steps}; K4 = 2 x {L}"
              f" x ({steps} steps + {steps + 1} validations); K5, K7s 1 from the sample-major call)",
              flush=True)
    else:
        exact = {kid: L * steps for kid in ("K7", "K8", "K9", "K10")} | {"K11": 0, "K7s": 0}
        print(f"  launches {launches} (K7, K8, K9, K10 = {L} x {steps})", flush=True)
    check(hist["steps"] == steps, f"fine-tune ran {hist['steps']} of {steps} steps")
    check(bool(np.isfinite(loss).all() and np.isfinite(gn).all()), "non-finite loss or grad norm")
    check(hist["skipped_steps"] == 0, f"{hist['skipped_steps']} steps skipped by the non-finite guard")
    if device.type == "cuda":
        for kid, n in exact.items():
            check(launches[kid] == n, f"{kid} launched {launches[kid]} times in {steps} steps, expected {n}")
        for kid in ("K1", "K3") if flash else ("K1", "K2a", "K2b", "K3"):
            check(launches[kid] >= L * steps, f"{kid} launched {launches[kid]} times")
        # training and validation in bf16: every K1 (and K5) and K2b launch
        # took the wgmma body, and so did the per-row attention of every K7
        # (and K7s) launch
        check_wgmma_bodies("fine-tune", launches, bodies, ("K2b",) + FEAT_IDS + ("K7", "K7s"))
    print(f"  feature attention, K2b and K7's per-row attention by body "
          f"{({k: v for k, v in bodies.items() if v and k[:2] != 'K3'})}",
          flush=True)

    check("snapshot_write_errors" not in hist, f"snapshot write failed: {hist.get('snapshot_write_errors')}")
    # the best snapshot replaces the initial one when validation improved
    # (a step's error below the initial one is the best error)
    improved = any(err == hist["best_val_error"] for _, err in hist["val_error"])
    base_model = load_npz(model_path)
    snap_model = load_model(out_path, mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8)
    mq = base_model.config.multiquery_item_attention_for_test_set
    check(snap_model.config.multiquery_item_attention_for_test_set == mq,
          "the snapshot lost the base model's multiquery_item_attention_for_test_set")
    base, snap = flatten_params(base_model.params), flatten_params(snap_model.params)
    check(snap.keys() == base.keys(), "the snapshot's leaves differ from the base model's")
    moved = max(float((snap[k].float() - base[k].float()).abs().max()) for k in base)
    print(f"  validation improved: {improved}; the snapshot differs from the base model by "
          f"{moved:.3e} (max abs)", flush=True)
    check((moved > 0) == improved, "the snapshot on disk is not the best one of the run")
    n_tr = int(round(0.8 * len(X)))
    clf = make_classifier(device, out_path)
    clf.fit(X[:n_tr], img[:n_tr], y[:n_tr])
    kernels.reset_launches()
    p = clf.predict_proba(X[n_tr:], img[n_tr:])
    served = dict(kernels.LAUNCHES)
    check_proba(p, len(X) - n_tr, clf.n_classes_, "fine-tuned snapshot")
    if device.type == "cuda" and flash:
        check(served["K4"] >= 2 * L and served["K2a"] == 0,
              f"the snapshot was not served through K4: {served}")
    print(f"  the best snapshot ({out_path.name}, multiquery test block {mq}) served by "
          f"MMPFNClassifier: predict_proba({len(X) - n_tr} rows) rows sum to 1"
          + (f", K4 launched {served['K4']} times, K2a {served['K2a']}" if flash else ""), flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return dict(launches=launches, hist=hist, warm_step_ms=warm, wall_s=wall)


def episode_trainer(device, model_path, data, n_layers, compute_dtype, use_kernels, seed=0,
                    override=None):
    """`fine_tune_mmpfn`'s step loop (`train/finetune.make_episode_trainer`)
    on the flagship's train split: the model cut to its first ``n_layers``,
    the kernels on or off, and ``override``'s config fields."""
    import numpy as np

    from multimodalpfn_tpu_torch.train.finetune import create_val_data, make_episode_trainer

    X, img, y = data
    X_tr, _, i_tr, _, y_tr, _ = create_val_data(X=X, image=img, y=y, rng=np.random.RandomState(seed),
                                                is_classification=True)
    return make_episode_trainer(
        path_to_base_model=str(model_path), mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8,
        features_per_group=1, X_train=X_tr, image_train=i_tr, y_train=y_tr, device=device,
        random_seed=seed, compute_dtype=compute_dtype,
        cfg_override=dict(nlayers=n_layers, fused_ops=use_kernels, use_flash=use_kernels)
        | (override or {}),
    )


def phase_finetune_kernel_vs_plain(device, model_path, data, n_layers, steps=3, override=None,
                                   expect=None) -> dict:
    """Float32 training steps from the same seed on the kernel path (with
    ``override``'s config fields) and on the plain path: the first step's
    gradient of every leaf within `FT_GRAD_REL_BOUND` of the plain path's,
    relative to that leaf's largest magnitude; train loss and gradient norm
    within `FT_STEP_REL_BOUND` relative, the params after the steps within
    `FT_PARAM_ABS_BOUND`. As a control, the same per-leaf measure between the
    first and the second step's gradients (another episode) is printed. The
    counters show the kernel path ran each kernel of ``expect`` (default:
    K7-K10 once per layer and step) as often as it says, and the plain path
    no kernel."""
    import torch

    from multimodalpfn_tpu_torch.models.params import flatten_params
    from multimodalpfn_tpu_torch.ops import kernels

    def leaf_rel(got: dict, want: dict) -> dict:
        """Per leaf: max |got - want| over max |want| (0 where both are 0)."""
        out = {}
        for k, w in want.items():
            err, ref = float((got[k] - w).abs().max()), float(w.abs().max())
            out[k] = err / ref if ref > 0 else (0.0 if err == 0 else float("inf"))
        return out

    runs = {}
    for use_kernels in (True, False):
        kernels.reset_launches()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        trainer = episode_trainer(device, model_path, data, n_layers, "float32", use_kernels,
                                  override=override if use_kernels else None)
        metrics, grads = [], []
        for _ in range(steps):
            m = trainer.step()
            metrics.append((float(m["loss"]), float(m["grad_norm"]), bool(m["applied"])))
            grads.append({k: v.grad.detach().clone() for k, v in flatten_params(trainer.state.params).items()
                          if v.grad is not None})
        peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else float("nan")
        params = {k: v.detach() for k, v in flatten_params(trainer.state.params).items()}
        runs[use_kernels] = (metrics, grads, params, dict(kernels.LAUNCHES), peak)
        del trainer
    (mk, gk, pk, lk, peak_k), (mp, gp, pp, lp, peak_p) = runs[True], runs[False]
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(mk, mp))
    gn_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(mk, mp))
    param_err = max(float((pk[k] - pp[k]).abs().max()) for k in pp)
    check(gk[0].keys() == gp[0].keys(), "the two paths give gradients to different leaves")
    grad_rel = leaf_rel(gk[0], gp[0])
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])
    control = sorted(leaf_rel(gk[0], gp[1]).values()) if steps > 1 else [float("nan")]
    print(f"  {steps} float32 steps, {n_layers} layers: losses kernel {[m[0] for m in mk]} plain "
          f"{[m[0] for m in mp]}; grad norms kernel {[m[1] for m in mk]} plain {[m[1] for m in mp]}",
          flush=True)
    print(f"  first step's gradients, {len(grad_rel)} leaves: largest per-leaf rel err "
          f"{worst[0][1]:.3e} (bound {FT_GRAD_REL_BOUND}), worst leaves "
          f"{[(k, f'{v:.2e}') for k, v in worst[:4]]}; control (kernel path step 1 against plain "
          f"path step 2, another episode): per-leaf min {control[0]:.3e}, median "
          f"{control[len(control) // 2]:.3e}", flush=True)
    print(f"  loss rel err {loss_rel:.3e}, grad norm rel err {gn_rel:.3e} (bound {FT_STEP_REL_BOUND}); "
          f"params max abs err {param_err:.3e} (bound {FT_PARAM_ABS_BOUND}); peak memory kernel "
          f"path {peak_k:.2f} GiB, plain path {peak_p:.2f} GiB; launches kernel path "
          f"{ {k: v for k, v in lk.items() if v} }", flush=True)
    check(all(m[2] for m in mk + mp), "a float32 step was skipped by the non-finite guard")
    check(worst[0][1] <= FT_GRAD_REL_BOUND,
          f"first step's gradient of {worst[0][0]} differs from the plain path by {worst[0][1]:.3e}")
    check(loss_rel <= FT_STEP_REL_BOUND and gn_rel <= FT_STEP_REL_BOUND,
          f"kernel path loss / grad norm differ from the plain path by {loss_rel:.3e} / {gn_rel:.3e}")
    check(param_err <= FT_PARAM_ABS_BOUND, f"params after {steps} steps differ by {param_err:.3e}")
    if expect is None:
        expect = {kid: n_layers * steps for kid in ("K7", "K8", "K9", "K10")}
    if device.type == "cuda":
        for kid, n in expect.items():
            check(lk[kid] == n, f"{kid} launched {lk[kid]} times on the kernel path, expected {n}")
        check(not any(lp.values()), f"the plain path launched kernels: {lp}")
    return dict(loss_rel=loss_rel, gn_rel=gn_rel, param_err=param_err, grad_rel=worst[0][1],
                control_median=control[len(control) // 2])


def phase_profile_step(device, model_path, data, n_layers, top: int = 16, label="") -> None:
    """torch.profiler around one warm bf16 training step on the kernel path
    (two steps before it): wall time (host clock, ended by a device
    synchronise), the sum of device kernel times, the idle share and the
    kernels that took the most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer = episode_trainer(device, model_path, data, n_layers, "bfloat16", True)
    for _ in range(2):
        trainer.step()
    batch = trainer.next_batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.state, m = trainer.train_step(trainer.state, batch, trainer.generator)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    print_profile(f"one warm training step{label} ({n_layers} layers, bf16)", wall,
                  device_kernel_rows(prof), top)


def phase_resume(device, model_path, data, out_path, steps, every) -> dict:
    """``fine_tune_mmpfn`` for ``steps`` bf16 steps writing its state every
    ``every`` (before step ``every``, so the file holds the state after step
    ``every - 1``), then: the state restored into a fresh train state equals
    the file bit for bit (params, the optimizer's z and ν, its counters, the
    step); the same state recomputed by the episode loop from the same seed
    is printed beside it; and a second call with ``resume=True`` starts at
    step ``every`` and ends at step ``steps`` with finite losses."""
    import numpy as np
    import torch

    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn
    from multimodalpfn_tpu_torch.train.step import restore_train_state, train_state_arrays

    X, img, y = data
    state_path = Path(str(out_path) + ".state.npz")
    state_path.unlink(missing_ok=True)
    kw = dict(mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8, features_per_group=1, X_train=X,
              image_train=img, y_train=y, path_to_base_model=str(model_path),
              save_path_to_fine_tuned_model=str(out_path), device=str(device), random_seed=0,
              state_checkpoint_every=every, finetuning_config={"max_steps": steps})
    first = fine_tune_mmpfn(**kw)
    check(first["steps"] == steps and "snapshot_write_errors" not in first,
          f"the first call ran {first['steps']} steps, write errors {first.get('snapshot_write_errors')}")
    with np.load(state_path) as f:
        saved = {k: f[k] for k in f.files}
    saved_step = int(saved["step"])
    check(saved_step == every - 1, f"the state file holds step {saved_step}, expected {every - 1}")
    # restore into a fresh state of the same model, optimizer and freeze mask
    fresh = episode_trainer(device, model_path, data, 12, "bfloat16", True)
    restore_train_state(state_path, fresh.state)
    restored = {k: v.cpu().numpy() for k, v in train_state_arrays(fresh.state).items()}
    same = restored.keys() == saved.keys() and all(
        restored[k].dtype == saved[k].dtype and np.array_equal(restored[k], saved[k]) for k in saved)
    del fresh
    # the state after `saved_step` steps of the same loop, recomputed
    again = episode_trainer(device, model_path, data, 12, "bfloat16", True)
    for _ in range(saved_step):
        again.step()
    recomputed = {k: v.cpu().numpy() for k, v in train_state_arrays(again.state).items()}
    drift = max(float(np.abs(recomputed[k].astype(np.float64) - saved[k]).max()) for k in saved)
    del again
    if device.type == "cuda":
        torch.cuda.empty_cache()
    resumed = fine_tune_mmpfn(**kw, resume=True)
    starts = resumed["val_error"][0][0] if resumed["val_error"] else None
    loss = resumed["train_loss"]
    print(f"  {steps} steps with the state written every {every}: the file holds step {saved_step} "
          f"({len(saved)} arrays); restored bit for bit: {same}; the loop's own state after "
          f"{saved_step} steps, recomputed, differs from the file by {drift:.3e} (max abs, not "
          f"gated); resumed at step {starts}, ended at step {resumed['steps']}, train loss "
          f"{[round(v, 5) for v in loss]} (the first run's {[round(v, 5) for v in first['train_loss']]})",
          flush=True)
    check(same, "the restored train state differs from the saved one")
    check(starts == saved_step + 1 and resumed["steps"] == steps
          and len(loss) == steps - saved_step,
          f"the resumed run covered steps {starts}..{resumed['steps']} ({len(loss)} steps)")
    check(bool(np.isfinite(loss).all()) and resumed["skipped_steps"] == 0,
          "the resumed run has a non-finite loss or a skipped step")
    return dict(saved_step=saved_step, restored_bit_equal=same, recompute_drift=drift,
                resumed_from=starts, resumed_loss=loss)


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
    bodies = dict(kernels.BODY_LAUNCHES)
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
    print(f"  launches {launches} (at least {need}; {', '.join(idle)} 0); by body "
          f"{ {k: v for k, v in bodies.items() if v} }", flush=True)
    if device.type == "cuda":
        for kid, n in need.items():
            check(launches[kid] >= n, f"{kid} launched {launches[kid]} times, expected >= {n}")
        for kid in idle:
            check(launches[kid] == 0, f"{kid} launched {launches[kid]} times on the {fit_mode} path")
        # bf16 at e = 192 (d = 32, nhid = 768): every K2b, K3, K1, K5, K6a
        # and K6b launch took the wgmma body
        check_wgmma_bodies(fit_mode, launches, bodies)
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
                at_fit, bodies = dict(kernels.LAUNCHES), dict(kernels.BODY_LAUNCHES)
                kernels.reset_launches()
                for n in request_sizes:
                    check_proba(clf.predict_proba(X_te[:n], img_te[:n]), n, clf.n_classes_,
                                f"{plan} {fit_mode} request of {n} rows")
                launches = dict(kernels.LAUNCHES)
                bodies = {k: v + kernels.BODY_LAUNCHES[k] for k, v in bodies.items()}
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
                    check_wgmma_bodies(f"{plan} {fit_mode}",
                                       {k: at_fit[k] + launches[k] for k in launches}, bodies)
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
            print_profile(f"{fit_mode} request of {n} rows", wall, device_kernel_rows(prof), top)


def kernel_rows(kres: dict, launches: dict) -> list[dict]:
    """The ``kernels`` line: per kernel its bf16 numbers at the first shape
    (``ms`` etc.), every other measurement under its own key."""
    rows = []
    for kid, meta in KERNELS.items():
        r = dict(kres[kid])
        for sub in ("t48", "prime", "predict", "ft", "test", "folded", "ft_train", "ft_test",
                    "ft_folded"):
            r.update({f"{k}_{sub}": v for k, v in kres.get(f"{kid}@{sub}", {}).items()})
        main = {"max_abs_err": "max_abs_err_f32", "ms": "ms_bf16", "plain_ms": "plain_ms_bf16",
                "bound_ms": "bound_ms_bf16", "bound_by": "bound_by_bf16",
                "library_ms": "library_ms_bf16"}
        row = {"name": meta["name"], "route": "cuda", "source": meta["source"],
               "replaces": meta["replaces"], "launches": launches[PATH_OF[kid]][kid]}
        row.update({k: r[v] for k, v in main.items()})
        if kid == "K3":
            row["launches_cached"] = launches["cached"]["K3"]
        if kid in ("K1", "K2a", "K2b", "K3"):
            row["launches_finetune"] = launches["finetune"][kid]
            row["launches_flash_finetune"] = launches["flash_finetune"][kid]
        if kid == "K4":
            row["launches_flash_finetune"] = launches["flash_finetune"]["K4"]
        row.update({k: v for k, v in r.items() if k not in main.values()})
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase at a tiny size on the CPU; exits 1")
    ap.add_argument("--profile", action="store_true",
                    help="add phase 14: profile one warm request of each size and a training step "
                         "of each item path")
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
        hgmma, prods, k3_sass, feat_sass, k2b_sass, row_sass = wgmma_sass_counts(kernels.library_path())
        print(f"  HGMMA instructions in the SASS of the bf16 attention kernels (K2a and K4 forward, "
              f"K9 and K11 passes): {hgmma}", flush=True)
        print(f"  (HGMMA, local loads and stores) in the SASS of the bf16 product tile "
              f"(gemm_tile.cuh, the products of K7-K10): {prods}", flush=True)
        check(len(hgmma) == 18 and min(hgmma.values()) > 0,
              "the bf16 attention kernels do not all issue wgmma")
        check({k.split()[0] for k in prods} == {"GeluEpi", "MulEpi", "AddStore", "Partial", "Store"}
              and all(h > 0 and spills == 0 for h, spills in prods.values()),
              "the bf16 products do not all issue wgmma without spilling")
        print(f"  (HGMMA, local loads and stores) in the SASS of K3's wgmma body (mlp_ln.cu, by "
              f"width): {k3_sass}", flush=True)
        check({k.split()[1] for k in k3_sass} == {"e=64", "e=128", "e=192"}
              and all(h > 0 and spills == 0 for h, spills in k3_sass.values()),
              "K3's wgmma body does not issue wgmma without spilling at every width")
        print(f"  (HGMMA, local loads and stores) in the SASS of the wgmma body of K1, K5, K6a, K6b "
              f"(feat_attn.cu, by width): {feat_sass}", flush=True)
        check(set(feat_sass) == {f"{kid} {w}" for kid in FEAT_IDS for w in ("e=64 d=16", "e=192 d=32")}
              and all(h > 0 and spills == 0 for h, spills in feat_sass.values()),
              "the feature-attention wgmma body does not issue wgmma without spilling everywhere")
        serial = serialized_wgmma(kernels.build_log(), "feat_attn_wg_kernel")
        print(f"  ptxas serialization warnings (C75xx) for the feature-attention wgmma body: "
              f"{len(serial)}", flush=True)
        check(kernels.build_log() != "" and not serial,
              "ptxas serialized the feature-attention body's wgmma (or printed no report): "
              + "; ".join(serial[:2]))
        print(f"  (HGMMA, local loads and stores) in the SASS of K2b's wgmma body (item_epilogue.cu, "
              f"by width): {k2b_sass}", flush=True)
        check({k.split()[1] for k in k2b_sass} == {"e=64", "e=128", "e=192"}
              and all(h > 0 and spills == 0 for h, spills in k2b_sass.values()),
              "K2b's wgmma body does not issue wgmma without spilling at every width")
        serial = serialized_wgmma(kernels.build_log(), "epilogue_ln_wg_kernel")
        print(f"  ptxas serialization warnings (C75xx) for K2b's wgmma body: {len(serial)}", flush=True)
        check(not serial, "ptxas serialized K2b's wgmma body: " + "; ".join(serial[:2]))
        print(f"  (HGMMA, local loads and stores) in the SASS of the per-row attention of K7 and "
              f"K7s (feat_attn_bwd.cu, row_wg, by pass and width): {row_sass}", flush=True)
        check(set(row_sass) == {f"{kid} {pas} d={d}" for kid in ("K7", "K7s") for pas in ("fwd", "bwd")
                                for d in (16, 32, 64)}
              and all(h > 0 and spills == 0 for h, spills in row_sass.values()),
              "K7's per-row attention does not issue wgmma without spilling everywhere")
        serial = serialized_wgmma(kernels.build_log(), "row_wg")
        print(f"  ptxas serialization warnings (C75xx) for K7's per-row attention: {len(serial)}",
              flush=True)
        check(not serial, "ptxas serialized K7's per-row attention: " + "; ".join(serial[:2]))
        # K2a's bf16 projection is the instantiation through which K9
        # recomputes qkv: its warnings are reported, not gated
        serial = serialized_wgmma(kernels.build_log(), PROJ_INSTANTIATION)
        print(f"  ptxas serialization warnings (C75xx) for the product tile of K2a's projection "
              f"(<false, true, Store<bf16>>, shared with K9): {len(serial)} "
              f"{sorted({ln[ln.rfind('('):] for ln in serial})}", flush=True)
    model_path = ROOT / "build" / "chip_smoke_model.npz"
    write_model(model_path)
    nmq_path = ROOT / "build" / "chip_smoke_model_no_multiquery.npz"
    write_model(nmq_path, multiquery=False)

    print("== phase 2: kernels against their plain versions", flush=True)
    if args.rehearse:
        dims, iters = (2, 7, 40, 30, 32, 4, 8, 64, 16), 1
    else:
        dims, iters = (4, 31, 2350, 1838, 192, 6, 32, 768, 512), 10
    ft_dims = (1, 5, 37, 21, 32, 4, 8, 64) if args.rehearse else FT_DIMS
    kres = phase_kernels(device, dims, iters, ft_dims)

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

    print("== phase 8: backward kernels against their plain versions (fine-tune shapes)", flush=True)
    kres |= phase_bwd_kernels(device, ft_dims, iters)
    if device.type == "cuda":
        prints = f32_fingerprints(device)
        print(f"  CUDA-core (and mma.sync) outputs (sha256): {prints}", flush=True)
        check(prints == PARENT_F32_SHA256,
              f"CUDA-core outputs differ from the parent commits': {prints} != {PARENT_F32_SHA256}")

    ft_data = (X, img, y)
    ft_steps, ft_layers = (2, 12) if args.rehearse else (FT_STEPS, 12)
    print(f"== phase 9: fine_tune_mmpfn, {ft_steps} bf16 steps, then the snapshot served", flush=True)
    ft = phase_finetune(device, model_path, ft_data, ft_steps, ft_layers,
                        ROOT / "build" / "chip_smoke_finetuned.ckpt")
    print("== phase 10: fine-tune kernel path against plain path (float32)", flush=True)
    cmp_layers = 1 if args.rehearse else FT_CMP_LAYERS
    ft_cmp = phase_finetune_kernel_vs_plain(device, model_path, ft_data, cmp_layers)

    print(f"== phase 11: fine_tune_mmpfn with the fused item gate refused (no multiquery test "
          f"block), {ft_steps} bf16 steps, then the snapshot served", flush=True)
    fl = phase_finetune(device, nmq_path, ft_data, ft_steps, ft_layers,
                        ROOT / "build" / "chip_smoke_finetuned_flash.ckpt", flash_dims=ft_dims)
    print("== phase 12: flash-path fine-tune kernel path against plain path (float32)", flush=True)
    flash_expect = {"K7": 3 * cmp_layers, "K8": 3 * cmp_layers, "K11": 2 * 3 * cmp_layers,
                    "K9": 0, "K10": 0, "K2a": 0, "K2b": 0}
    print("  the checkpoint without the multiquery test block:", flush=True)
    fl_cmp = phase_finetune_kernel_vs_plain(device, nmq_path, ft_data, cmp_layers, expect=flash_expect)
    print("  the multiquery checkpoint with fused_item=False (the folded K11):", flush=True)
    fold_cmp = phase_finetune_kernel_vs_plain(device, model_path, ft_data, cmp_layers,
                                              override={"fused_item": False}, expect=flash_expect)
    print(f"== phase 13: resume ({RESUME_STEPS} bf16 steps, state every {RESUME_EVERY})", flush=True)
    res = phase_resume(device, nmq_path, ft_data, ROOT / "build" / "chip_smoke_resume.ckpt",
                       RESUME_STEPS, RESUME_EVERY)

    if args.profile:
        print("== phase 14: profile of warm requests and of a warm training step of each item "
              "path", flush=True)
        phase_profile(device, model_path, data, sizes)
        phase_profile_step(device, model_path, ft_data, ft_layers)
        phase_profile_step(device, nmq_path, ft_data, ft_layers, label=" of the flash path")

    rows = kernel_rows(kres, {"preproc": pre["launches"], "cached": kv["launches"],
                              "finetune": ft["launches"], "flash_finetune": fl["launches"]}
                       | {f"{plan}{'_cached' if mode == 'fit_with_cache' else ''}": run["launches"]
                          for (mode, plan), run in forced.items()})
    print(f"  fit_preprocessors: fit {pre['fit_ms']:.1f} ms, requests ms {pre['times']}, "
          f"warm {pre['warm']}; fit_with_cache: fit {kv['fit_ms']:.1f} ms, requests ms "
          f"{kv['times']}, warm {kv['warm']}, "
          f"predict_proba_many {kv['many_ms']:.1f} ms; f32 proba err {proba_err:.3e} "
          f"(cached {kv_err:.3e}); fine-tune {ft['hist']['steps']} steps in {ft['wall_s']:.1f} s, "
          f"warm step {ft['warm_step_ms']:.1f} ms, f32 kernel vs plain loss {ft_cmp['loss_rel']:.2e} "
          f"grads {ft_cmp['grad_rel']:.2e} params {ft_cmp['param_err']:.2e}; flash-path fine-tune "
          f"{fl['hist']['steps']} steps in {fl['wall_s']:.1f} s, warm step {fl['warm_step_ms']:.1f} ms, "
          f"f32 kernel vs plain grads {fl_cmp['grad_rel']:.2e} (folded {fold_cmp['grad_rel']:.2e}); "
          f"resumed at step {res['resumed_from']}; total {time.perf_counter() - t_start:.1f} s",
          flush=True)
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
