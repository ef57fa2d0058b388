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
   of K3's wgmma body (``mlp_ln.cu``, e = 64, 128, 192), of K8's row pass
   (``mlp_ln_bwd.cu``, e = 64, 128, 192), of the wgmma body
   of K1, K5, K6a and K6b (``feat_attn.cu``, e = 64 and 192), of K2b's
   (``item_epilogue.cu``, e = 64, 128, 192) and of the per-row attention
   of K7 and K7s (``feat_attn_bwd.cu``, ``row_wg``: forward and softmax
   backward, both layouts, d = 16, 32, 64) and of K10's row pass
   (``item_epilogue_bwd.cu``, e = 64, 128, 192), each of which must issue
   wgmma with no local-memory load or store; the ``-Xptxas -v`` report must
   hold no serialization warning (C75xx) for K8's row pass, the last three
   and K10's row pass, whose registers and spills it prints (those of the
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
   183 queries; folded G = 30, 6·183 queries; 1655 keys) and DINOv2's
   attention (``K4@dinov2``: G = 16 images × 12 heads, 577 × 577, d = 64),
   each with SDPA beside it; K5 at the
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
   twice on the same inputs must give the same bits. K8's row pass (bf16)
   also at e = 64 and 128 and on 100 rows, fewer than one of its tiles;
   K10's at e = 64 and 128 and on 3 groups of 100 rows (units of 64 rows
   straddle the groups), there also with heads of d = 48 that span its
   64-column chunks and at h·d = 256. Times, bounds, and for
   K9 the backward of ``scaled_dot_product_attention`` over both regions.
   For bf16 K7, K7s, K8 and K10, each launch of the sequence by profiler name,
   each product beside ``torch.matmul`` on operands of its shapes, and each
   launch's bytes over the HBM rate (`bwd_products`); K7's and K7s' two
   per-row attention launches also beside their exponential floor and SDPA
   (forward, and its backward) on the same shapes as (rows·h, t, d); the
   kernels line carries the measured ones as ``products_ms``,
   ``matmul_ms`` and ``attn_sdpa_ms``.
9. ``fine_tune_mmpfn`` served: 100 bf16 steps on the PAD-UFES-shaped set (the
   full 12 layers, validation after every step); the counters, zeroed just
   before, show K7, K8, K9 and K10 launched 12 times per step, every K1
   and K2b launch (training and validation) on its wgmma body, the
   per-row attention of every K7 launch on its wgmma body and every K8
   and K10 launch on its row pass; every loss and
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

15. ``fit_preprocessors`` served by ``MMPFNRegressor`` (the same data, model
   architecture and kernels, with a regression target of the script's own:
   the class code, half of feature 18 and lognormal noise, σ = 0.5, from
   ``default_rng(1)``; the published 192×12 regressor, ``max_num_classes``
   0, 5000 bars over ``linspace(-12, 12, 5001)``, random weights from seed
   0, output projections from seed 1; 4 members with the default
   preprocessing and target transforms None / safepower): the member widths,
   target transforms and planned groups printed; three bf16
   ``predict(output_type="full")`` requests with the counters zeroed just
   before, checked as phase 3's (K1 or K6a, K2a, K2b, K3 in every layer of
   every group, each on its wgmma body); mean, median, mode and the nine
   quantiles finite, the quantiles monotone and the median between the 0.1
   and 0.9 quantiles; then the requests warm, each timed on the host clock
   as dispatch + forward + fetch of the member logits and, apart, the host
   finalize (border transforms, translation, average, statistics).
16. Its kernel path against its plain path, float32: the averaged bar
   probabilities within 1e-4 absolute, mean, median and quantiles within
   1e-4 of std(y_train).
17. ``fit_with_cache`` served by the regressor: as phase 5 (K4, K5 or K6b and
   K3 in every layer of the prime and of each request, no item-major
   kernel), ``predict_many`` equal to the sequential answers bit for bit.
18. ``fine_tune_mmpfn(task_type="regression", validation_metric="rmse")``
   on the regressor: 20 bf16 steps on the 12 layers, validation after every
   step, K7-K10 launched 12 times a step, every K1 and K2b launch and K7's
   per-row attention on the wgmma body, every loss and gradient norm
   finite; the snapshot keeps the borders and ``MMPFNRegressor`` serves it;
   then three float32 steps on 3 layers, kernel path against plain path, as
   phase 10.
26. (Run after 18.) The regressor of phase 15 with each quantile and robust
   target transform, ``REGRESSION_Y_PREPROCESS_TRANSFORMS=(None, name)`` for
   ``quantile_uni_coarse``, ``quantile_norm_coarse``, ``quantile_uni``,
   ``quantile_norm``, ``quantile_uni_fine``, ``quantile_norm_fine`` and
   ``robust``: the members' target transforms checked against the name; one
   bf16 ``predict(output_type="full")`` of the 460 test rows with the
   counters zeroed just before, checked as phase 15's (K1 or K6a, K2a, K2b,
   K3 on their wgmma bodies; every answer as `check_regression`), then the
   same request warm, split into dispatch + forward + fetch and host
   finalize (the borders go back through the quantile or robust inverse on
   the host). ``quantile_norm`` and ``robust`` also in ``fit_with_cache`` as
   phase 17 (K6b, K4, K3; ``predict_many`` equal to sequential predict bit
   for bit) and as phase 16's float32 kernel path against plain path.

19. The sweep, served by the kernels: ``fine_tune_batched_cells``
   (`train/finetune_batch.py`) on the same data and model at full width,
   bf16, the MGM+CAP cells mgm 16 and mgm 32 (cap 8), seeds 0 and 1: 4 runs
   with their mixers padded to 32 heads, 10 steps at lr 1e-5, validation
   after every step. The counters, zeroed just before, show K1, K2a, K2b and
   K3 launched 4 x (10 + 11) x 12 times, K7, K8, K9 and K10 4 x 10 x 12,
   every K1, K2b, K3 launch and K7's per-row attention on the wgmma body;
   every loss and validation error finite; the sweep step's median time on
   the host clock, per step and per run. The mgm-16 runs, extracted at
   their true shape (``extract_run_params``) and saved, are served by
   ``MMPFNClassifier``.
20. The sweep's float32 gates on the first three layers: (a) three steps
   of the same sweep, kernel path against plain path (losses 1e-4
   relative, params 1e-5 absolute); (b) the two cells in one sweep against
   each alone: at lr 1e-12 the losses within 1e-5 relative and the
   extracted mixers within 1e-9, at lr 1e-5 the losses within 1e-4; (c) a
   padded MGM group (mgm 2 and 4, 2 seeds), two bf16 steps launching K2a,
   K2b, K9 and K10 and no K1, K3, K7 or K8 (its masked feature attention
   and its MLP run plain), and its float32 kernel path against its plain
   path within (a)'s bounds.
21. The grid study: ``run_experiment_cross_cell`` over mgm {4, 16, 32} x
   cap {8}, 2 seeds, 3 steps (checkpoints under ``build/``), then
   ``run_experiment`` on the mgm-16 cell for 1 seed and 2 steps, the
   counters zeroed before each: mgm 4 pruned, every other trial complete
   with all its seeds and an accuracy in [0, 1], no trial failed, the
   forward and backward kernels launched; the study JSON round-trips.

22. DINOv2 ViT-B/14 at full width (768 wide, 12 blocks, 12 heads, bf16,
   random weights from ``init_vit_params``): ``embed_images`` over one image
   a row of the PAD-UFES-shaped set (2298 images at 336 px, pixels uniform in
   [0, 1) drawn batch by batch), 16 images a batch; the counters, zeroed
   just before, show K4 launched 12 times a batch (1728) and no other
   kernel, the embeddings ``(2298, 1, 768)`` finite; the first and the warm
   batch times and the total are printed. Then ``MMPFNClassifier`` fits the
   first 1838 rows with these embeddings in place of the synthetic ones and
   answers the other 460, checked as phase 3's requests.
23. The encoders' gates: DINOv2's kernel path against its plain path on 16
   images at full width (the largest CLS difference within 1e-4 of the
   largest CLS value in float32, 2**-6 in bf16); ELECTRA-base at full width
   (768, 12 layers, float32, random weights) on 64 random sequences of
   random lengths padded to 384 tokens: finite, and the CLS within 1e-5 of
   its largest value with padding appended to 512 tokens and with batches
   of 5 in place of 16; its masked attention is plain PyTorch, so no kernel
   launches.
24. The entry points, as a user runs them, in ``build/cli/`` (a
   PAD-UFES-20-shaped directory: ``metadata.csv`` of 2298 rows with the six
   diagnostics, phase 22's DINOv2 embeddings as the image cache, seeded
   random (2298, 1, 768) clinical-note embeddings as the text cache), each
   inside the port's ``PhaseTimer`` with the launch counters zeroed just
   before: ``scripts/run_published`` (configs 1-4, 1 seed, 20 fine-tune
   steps, phase 1's model), ``scripts/run_experiment`` (pad_ufes_20, a
   one-cell YAML mgm 16 × cap 8, 1 seed, the reference's 100 steps),
   ``scripts/finetune_cli`` (20 steps on ``pad_ufes_like``'s arrays saved
   as ``.npy``) and the five examples' ``main`` (phase 1's model, the
   regressor's for the regression example). Each CLI's printed JSON equals
   what it returned and the file it wrote; every estimator fitted and
   every fine-tune holds its parameters and train split on the card; K7,
   K8, K9 and K10 launch exactly 12 times a fine-tune step, the served
   forward kernels run, and every K1, K5, K6a, K6b, K2b and K3 launch and
   K7's per-row attention take the wgmma body; ``run_published``'s config-1
   accuracy and AUROC equal, bit for bit, a direct ``TabPFNClassifier``
   call with the same arguments; config 1 again inside
   ``utils/profiling.trace`` answers the same and its trace names the
   wgmma kernels; the serving example's pipelined answers equal its
   sequential ones. The ``PhaseTimer`` report and ``live_device_memory()``
   are printed.
25. Multi-device (`parallel/`), in processes the script spawns
   (`parallel/launch.run_ranks`), each rank failing the phase on its own
   check. (a) ``initialize_distributed`` on NCCL, one rank a card (a ring
   of one on a one-card machine), ``make_mesh``: ``ring_attention`` with
   ``use_flash`` forward and backward at the flash fine-tune's train block
   (q, k, v (30, 6, 1654, 32), G = 180) in float32 and bf16, held to K4 and
   K11 on the whole K/V (5e-5 and 2**-6 of each output's largest), K4 and
   K11 launched once a ring step, the ring's forward + backward timed
   against the whole K/V's. (b) Four ranks sharing the card over gloo (NCCL
   refuses two ranks on one device; gloo carries the CUDA tensors through
   host memory, and every block is still computed on the card by K4 and
   K11), as a (2, 2) mesh: a ring of two over ``dp``, two ``mp`` ranks.
   The published 192×12 model in float32 with the kernels on and the fused
   item sublayer off: ``forward`` on the flagship split (1838 train + 460
   test rows, 30 tokens) with ``seq_shard_axis="dp"`` against the same
   forward without a ring axis (1e-4 of the largest logit); one training
   step at the fine-tune episode cut to 1654 + 184 rows against the
   unsharded step (loss and every gradient leaf, 1e-4 relative), with K4
   and K11 launched exactly 2 × 12 × 2 times and K1, K3, K7, K8 12 times;
   phase 19's 4-run sweep for 3 steps over the 2 ``dp`` ranks equal, bit
   for bit, to a single-process run of the same 3 steps (histories and a
   digest of every final param); ``shard_estimator`` at ``mp`` = 2 serving
   phase 3's three requests bit for bit; and one ``dp × mp`` step on two
   episodes (one a ``dp`` rank, the params sharded over ``mp``) against the
   single-process step on both (loss, gradient norm and every gradient
   within 1e-4 relative, each gradient to its leaf's largest; the params
   after the step within 1e-5 absolute: the ``dp`` mean adds in another
   order). The ring step's time against the
   unsharded step's is printed (host clock, rank 0).

``--profile`` adds a phase 14, run last: ``torch.profiler`` around one warm
request of each size in both modes, around one warm training step of each
item path (the fused item sublayer and the flash path), around one warm
460-row regressor request, around the last of three sweep steps of
phase 19's sweep and around one warm batch of phase 22's ``embed_images``,
printing wall time, device kernel time, the idle share and the kernels
that took the most device time.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA the script exits
non-zero and prints no result. ``--rehearse`` runs the phases at a tiny size
on the CPU (plain versions only; phase 25 over gloo) to check the script
itself; it also exits non-zero.
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
# phase 8's further cases of K8's row pass: {id suffix: (x's leading shape,
# e)}, nhid = 4·e; 6030 rows (ragged against 128, three weight-gradient
# slabs) at e = 64 and 128, and 100 rows, fewer than one 128-row tile
K8_CASES = {"e64": ((1, 30, 201), 64), "e128": ((1, 30, 201), 128), "rows100": ((1, 1, 100), 192)}
# phase 8's further cases of K10's row pass: {id suffix: ((G, S), e, h, d)};
# 6030 rows at e = 64 and 128 (ragged against the 64-row units, which
# straddle the groups of 201); 3 groups of 100 rows at the flagship's
# widths, with heads of d = 48 that span the 64-column chunks of h·d, and
# at h·d = 256, the widest the row pass takes (two ring stages)
K10_CASES = {"e64": ((30, 201), 64, 2, 32), "e128": ((30, 201), 128, 4, 32),
             "rows300": ((3, 100), 192, 6, 32), "d48": ((3, 100), 192, 4, 48),
             "hd256": ((3, 100), 192, 8, 32)}
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
# the regressor: the bar probabilities of the kernel path against the plain
# path in float32 (absolute), and its mean, median and quantiles (absolute, in
# units of the train target's standard deviation); quantiles may step back
# by 1e-6 of it (the quantile function's rounding at a bar's edge)
REG_PROBA_ABS_BOUND = 1e-4
REG_STAT_REL_BOUND = 1e-4
REG_MONOTONE_SLACK = 1e-6
REG_FT_STEPS = 20
# phase 26: the regressor's quantile and robust target transforms, each as the
# second member pair's (None, name); the cached mode and the float32 gates
# take two of them
REG_TARGET_NAMES = ("quantile_uni_coarse", "quantile_norm_coarse", "quantile_uni", "quantile_norm",
                    "quantile_uni_fine", "quantile_norm_fine", "robust")
REG_TARGET_CACHED = ("quantile_norm", "robust")
# resume: the first call's steps and state cadence (the state is written
# before step 4, so it holds the state after step 3; the resumed call runs
# steps 4 to 6)
RESUME_STEPS, RESUME_EVERY = 6, 4
# the sweep (phases 19-21): the reference grid's shape, MGM+CAP cells of
# different mgm_heads sharing cap_heads, 2 seeds each, padded to 32 heads
SWEEP_CELLS = [{"mgm_heads": 16, "cap_heads": 8, "seeds": [0, 1]},
               {"mgm_heads": 32, "cap_heads": 8, "seeds": [0, 1]}]
SWEEP_STEPS = 10
# a padded MGM group (phase 20c): its image-token count follows mgm_heads
SWEEP_MGM_CELLS = [{"mgm_heads": 2, "cap_heads": 2, "seeds": [0, 1]},
                   {"mgm_heads": 4, "cap_heads": 2, "seeds": [0, 1]}]
# padded equals unpadded: at lr 1e-12 (no optimizer amplification) the losses
# relative and the extracted mixers absolute, the JAX test's check for
# leakage between runs (`tests/test_cross_cell_batching.py`)
SWEEP_TINY_LR, SWEEP_LOSS_REL_BOUND, SWEEP_MIXER_ABS_BOUND = 1e-12, 1e-5, 1e-9
STUDY_STEPS = 3
# DINOv2 ViT-B/14 (phases 2, 22, 23): the loaders' default 336 px (a 24 x 24
# patch grid and the CLS token: 577 tokens), batches of 16 images, 12 heads
# of d = 64: K4 at (16 x 12, 577, 64); phase 22 embeds pad_ufes_like's 2298
# images, 144 batches, so K4 launches 144 x 12 times
VIT_IMG, VIT_BATCH = 14 * 24, 16
VIT_ATTN_DIMS = (VIT_BATCH * 12, 1 + (VIT_IMG // 14) ** 2, 64)
# phase 23: DINOv2's kernel path against its plain path, the largest CLS
# difference relative to the largest CLS value (float32: the attention's
# summation order, through 12 blocks), and ELECTRA-base's CLS with padding
# appended or a batch cut differently (summation order of other shapes only:
# padded keys get an exact zero weight)
VIT_F32_REL_BOUND = 1e-4
ELECTRA_REL_BOUND = 1e-5
ELECTRA_SEQS, ELECTRA_LEN, ELECTRA_SHORT = 64, 512, 384


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
    K3's wgmma body (`csrc/mlp_ln.cu`) and K8's row pass
    (`csrc/mlp_ln_bwd.cu`) by width, of the wgmma body of K1,
    K5, K6a and K6b (`csrc/feat_attn.cu`) by width, layout and mask, of
    K2b's wgmma body (`csrc/item_epilogue.cu`) and K10's row pass
    (`csrc/item_epilogue_bwd.cu`) by width and of the per-row
    attention of K7 and K7s (`csrc/feat_attn_bwd.cu`, `row_wg`) by pass,
    layout and d, each with its local-memory loads and stores (spills)
    beside. Returns (attention counts, {product kernel: (HGMMA, LDL +
    STL)}, {K3 or K8 kernel: (HGMMA, LDL + STL)}, {feature-attention kernel:
    (HGMMA, LDL + STL)}, {K2b or K10 kernel: (HGMMA, LDL + STL)},
    {row-attention kernel: (HGMMA, LDL + STL)})."""
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
            elif "mlp_ln_bwd_wg_kernel" in name:
                gfn = f"K8 e={re.search(r'mlp_ln_bwd_wg_kernelILi(\d+)E', name).group(1)}"
                k3.setdefault(gfn, [0, 0])
            elif "epilogue_ln_wg_kernel" in name:
                gfn = f"K2b e={re.search(r'epilogue_ln_wg_kernelILi(\d+)E', name).group(1)}"
                k2b.setdefault(gfn, [0, 0])
            elif "epilogue_ln_bwd_wg_kernel" in name:
                gfn = f"K10 e={re.search(r'epilogue_ln_bwd_wg_kernelILi(\d+)E', name).group(1)}"
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
            table = (k3 if gfn.startswith(("K3", "K8")) else k2b if gfn.startswith(("K2b", "K10"))
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


def ptxas_usage(log: str, pattern: str) -> list[str]:
    """ptxas' spill and register lines (``-Xptxas -v``, `kernels.build_log`)
    of each kernel whose name contains ``pattern``, in the report's order."""
    import re

    out, mine = [], False
    for ln in log.splitlines():
        m = re.search(r"(Compiling entry function|Function properties for) '?(\S+?)'?( |$)", ln)
        if m:
            mine = pattern in m.group(2)
        elif mine and re.search(r"spill|Used \d+ registers", ln):
            out.append(ln.strip())
    return out


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
    """The launch sequences of K8 (`csrc/mlp_ln_bwd.cu`: "K8" its row pass,
    the bf16 body at e = 64, 128, 192; "K8 sequence" the body of float32
    and of bf16 at other widths), K10 (`csrc/item_epilogue_bwd.cu`: "K10"
    its row pass, the bf16 body at the widths of K2b's wgmma body; "K10
    sequence" the other) and K7 (`csrc/feat_attn_bwd.cu`; K7s launches the
    same) at ``dims`` (FT_DIMS' layout): per body its ``buffers`` {name:
    (shape, dtype)}, dtype "cd" (the compute dtype) or "f32", the
    allocations of `ops/fused.py` or `ops/item_fused.py` plus the weights
    and the weight gradients' slabs (views of ``work``); and its
    ``launches`` in order, each {name, reads, writes} and, for a product of
    `gemm_tile.cuh` (C = op(A)·op(B)), its M, N, K, a_t, b_t and operand
    buffers a, b. A row pass names the products it computes on chip
    (``products``, each {name, M, N, K}) and those of them that repeat a
    product the function computes once (``recomputed``: K8's z = x·W1
    again; K10's u = x + o·W_out, K2b's product, is the first and only
    time the backward computes it)."""
    b, t, S, _, e, h, d, nhid = dims
    R, hd = b * t * S, h * d
    slabs = max(1, -(-R // 2048))

    def prod(name, a, bb, M, N, K, reads, writes, a_t=False, b_t=False):
        return dict(name=name, a=a, b=bb, M=M, N=N, K=K, a_t=a_t, b_t=b_t, reads=reads,
                    writes=writes)

    def rows(name, reads, writes):
        return dict(name=name, reads=reads, writes=writes)

    k8_common = {
        "x": ((R, e), "cd"), "g": ((R, e), "cd"), "w1": ((e, nhid), "cd"),
        "w2": ((nhid, e), "cd"), "gz": ((R, nhid), "cd"), "du_c": ((R, e), "cd"),
        "dz": ((R, nhid), "cd"), "dx": ((R, e), "cd"), "dw1": ((e, nhid), "f32"),
        "dw2": ((nhid, e), "f32"), "work": ((slabs, e, nhid), "f32"),
        "slabs_dw1": ((slabs, e, nhid), "f32"), "slabs_dw2": ((slabs, nhid, e), "f32"),
    }
    k8_wgrads = [
        prod("dW1=xt.dz", "x", "dz", e, nhid, R, ["x", "dz"], ["slabs_dw1"], a_t=True),
        rows("sum_slabs dW1", ["slabs_dw1"], ["dw1"]),
        prod("dW2=gzt.du", "gz", "du_c", nhid, e, R, ["gz", "du_c"], ["slabs_dw2"], a_t=True),
        rows("sum_slabs dW2", ["slabs_dw2"], ["dw2"]),
    ]

    def on_chip(name, M, N, K, b_t=False):  # b_t: B stored (N, K), as torch.matmul times it
        return dict(name=name, M=M, N=N, K=K, b_t=b_t)

    k8 = {
        "buffers": k8_common,
        "launches": [
            dict(name="row pass", reads=["x", "g", "w1", "w2"], writes=["gz", "du_c", "dz", "dx"],
                 products=[on_chip("z=x.W1", R, nhid, e), on_chip("u=x+gz.W2", R, e, nhid),
                           on_chip("z=x.W1 again", R, nhid, e), on_chip("dh=du.W2t", R, nhid, e, True),
                           on_chip("dx=du+dz.W1t", R, e, nhid, True)],
                 recomputed=["z=x.W1 again"]),
            *k8_wgrads,
        ],
    }
    k8_sequence = {
        "buffers": k8_common | {"gzg": ((R, nhid), "f32"), "u": ((R, e), "f32"),
                                "du": ((R, e), "f32")},
        "launches": [
            prod("z=x.W1", "x", "w1", R, nhid, e, ["x", "w1"], ["gz", "gzg"]),
            prod("u=x+gz.W2", "gz", "w2", R, e, nhid, ["gz", "w2", "x"], ["u"]),
            rows("ln_bwd", ["u", "g"], ["du", "du_c"]),
            prod("dz=du.W2t*gelu'", "du_c", "w2", R, nhid, e, ["du_c", "w2", "gzg"], ["dz"],
                 b_t=True),
            prod("dx=du+dz.W1t", "dz", "w1", R, e, nhid, ["dz", "w1", "du"], ["dx"], b_t=True),
            *k8_wgrads,
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
    G = b * t
    k10_common = {
        "x": ((R, e), "cd"), "o": ((R, hd), "cd"), "g": ((R, e), "cd"), "wout": ((hd, e), "cd"),
        "du_c": ((R, e), "cd"), "do": ((R, hd), "cd"), "delta": ((G, h, S), "f32"),
        "dw": ((hd, e), "f32"), "work": ((slabs, hd, e), "f32"), "slabs_dwout": ((slabs, hd, e), "f32"),
    }
    k10_wgrad = [
        prod("dW_out=ot.du", "o", "du_c", hd, e, R, ["o", "du_c"], ["slabs_dwout"], a_t=True),
        rows("sum_slabs dW_out", ["slabs_dwout"], ["dw"]),
    ]
    k10 = {
        "buffers": k10_common,
        "launches": [
            dict(name="row pass", reads=["x", "o", "g", "wout"], writes=["du_c", "do", "delta"],
                 products=[on_chip("u=x+o.Wout", R, e, hd), on_chip("do=du.Woutt", R, hd, e, True)],
                 recomputed=[]),
            *k10_wgrad,
        ],
    }
    k10_sequence = {
        "buffers": k10_common | {"u": ((R, e), "f32"), "do32": ((R, hd), "f32")},
        "launches": [
            prod("u=x+o.Wout", "o", "wout", R, e, hd, ["o", "wout", "x"], ["u"]),
            rows("ln_bwd", ["u", "g"], ["du_c"]),
            prod("do=du.Woutt", "du_c", "wout", R, hd, e, ["du_c", "wout"], ["do32"], b_t=True),
            rows("delta", ["do32", "o"], ["do", "delta"]),
            *k10_wgrad,
        ],
    }
    return {"K8": k8, "K8 sequence": k8_sequence, "K7": k7, "K10": k10, "K10 sequence": k10_sequence}


def launch_bytes(seq: dict, launch: dict, es: int) -> int:
    """Bytes a launch of ``seq`` must move: each buffer it reads read once,
    each it writes written once (``es`` bytes an element of the compute
    dtype)."""
    import math

    return sum(math.prod(seq["buffers"][n][0]) * (es if seq["buffers"][n][1] == "cd" else 4)
               for n in launch["reads"] + launch["writes"])


def bwd_flops(dims) -> dict:
    """FLOPs of phase 8's work for K8 (six products of 2·e·nhid a row),
    K7's products (twelve of 2·e·h·d a token: the QKV and out-projection
    recomputed, do, dx, dW_qkv, dW_out) and K10's (three of 2·e·h·d a row:
    u, do, dW_out)."""
    b, t, S, _, e, h, d, nhid = dims
    R = b * t * S
    return {"K8": 12 * R * e * nhid, "K7": 2 * R * e * h * d * 12, "K10": 6 * R * e * h * d}


# the kernels of K7's, K8's and K10's launch sequences, by profiler name
SEQ_KERNELS = ("gemm::", "ln_bwd_kernel", "attn_o_kernel", "attn_bwd_kernel", "row_wg::attn_wg_kernel",
               "sum_slabs_kernel", "mlp_ln_bwd_wg_kernel", "epilogue_ln_bwd_wg_kernel", "delta_kernel")


def sequence_ms(fn, device, iters: int, names: list) -> dict | None:
    """Device ms per call of each launch of ``fn``'s launch sequence, by
    position: the profiler's kernels whose names hold one of `SEQ_KERNELS`
    (weight casts and copies left out), in start order, ``len(names)`` a
    call; {name: (ms, profiler name)}, or None off the card or where the
    count does not match in three traces (the profiler has been seen to
    drop one kernel of a trace)."""
    import torch

    if device.type != "cuda":
        return None
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = sorted((ev for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA
                      and any(k in ev.name for k in SEQ_KERNELS)),
                     key=lambda ev: ev.time_range.start)
        if len(evs) == iters * len(names):
            break
        print(f"  launch sequence: {len(evs)} kernels in {iters} calls, expected "
              f"{iters * len(names)}", flush=True)
    else:
        print("  launch sequence: not split", flush=True)
        return None
    out = {}
    for i, name in enumerate(names):
        mine = evs[i::len(names)]
        out[name] = (sum(ev.time_range.elapsed_us() for ev in mine) / 1e3 / iters, mine[0].name)
    return out


def matmul_ms(seq: dict, device, iters: int) -> dict:
    """``torch.matmul`` of bf16 operands of each product's shapes and
    storage orders (A (M, K) or stored (K, M); B (K, N) or stored (N, K)):
    the product alone, with no epilogue; a row pass's products on chip too
    (A (M, K), B as ``b_t`` says). Timed here, used nowhere in the port."""
    import torch

    out = {}
    prods = [p for ln in seq["launches"] for p in ([ln] if "M" in ln else ln.get("products", []))]
    for ln in prods:
        M, N, K, a_t, b_t = ln["M"], ln["N"], ln["K"], ln.get("a_t", False), ln.get("b_t", False)
        a = torch.randn((K, M) if a_t else (M, K), device=device, dtype=torch.bfloat16)
        bb = torch.randn((N, K) if b_t else (K, N), device=device, dtype=torch.bfloat16)
        a, bb = (a.t() if a_t else a), (bb.t() if b_t else bb)
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


def phase_kernels(device, dims, iters, ft_dims, vit_dims=VIT_ATTN_DIMS, only=None) -> dict:
    """Every kernel against its plain version on the same inputs (with
    ``only``, the cases whose ids start with one of its entries). K4 also
    runs at the flash fine-tune's three blocks (``ft_dims``, as `FT_DIMS`)
    and at DINOv2's attention (``vit_dims``, as `VIT_ATTN_DIMS`)."""
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

    def flash_work(G, Sq, Skv, d=d):
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
    # DINOv2's attention: a batch of images' heads, every token against every token
    vit_qkv = tuple(rand(*vit_dims) for _ in range(3))
    for kid, (qb, kb, vb) in (ft_blocks | {"K4@dinov2": vit_qkv}).items():
        cases[kid] = (flash.flash_attention, flash.flash_attention_plain,
                      lambda dt, qkv=(qb, kb, vb): tuple(a.to(dt) for a in qkv),
                      flash_work(qb.shape[0], qb.shape[1], kb.shape[1], qb.shape[2]),
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
    unfolded (no multiquery) and folded (the heads against KV head 0). K8
    also runs its bf16 row pass at e = 64 and 128 and on 100 rows, fewer than
    one 128-row tile (`K8_CASES`: ids ``K8@e64``, ``K8@e128``,
    ``K8@rows100``), and K10 its bf16 row pass at e = 64 and 128, on groups
    that its 64-row units straddle, with heads that span its chunks and at
    h·d = 256 (`K10_CASES`: ids ``K10@e64`` ...). For K7, K8 and K10 in bf16
    it also times each launch of their sequence by profiler name
    (`sequence_ms`), each product beside ``torch.matmul`` on operands of its
    shapes, and the sequence's bytes over the HBM rate (`bwd_products`: the
    row pass of K8 and K10 where the package picks it, the sequence
    otherwise). ``only`` restricts the kernels run (an id and the ids
    ``id@...``)."""
    import math

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

    def k10_work(rows_, e_, hd_, n_delta):
        """K10's three products (u, do, dW_out) and the per-head delta;
        x, g, du (e wide), o, do (h·d wide) and delta once, W_out read and
        dW_out written."""
        return lambda es: (6 * rows_ * hd_ * e_ + 2 * rows_ * hd_,
                           rows_ * (3 * e_ + 2 * hd_) * es + n_delta * 4 + hd_ * e_ * (es + 4))

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
                k10_work(R, e, hd, G * h * S)),
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
    # K8 at the other widths of its row pass (nhid = 4·e, as published) and
    # on fewer rows than one of its 128-row tiles; inputs from a generator
    # of their own, so that the other cases' inputs stay as they were
    gen8 = torch.Generator().manual_seed(8)
    for sub, (lead, e8) in K8_CASES.items():
        n8, r8 = 4 * e8, math.prod(lead)
        x8, g8 = (torch.randn((*lead, e8), generator=gen8).to(device) for _ in range(2))
        w18 = (torch.randn((e8, n8), generator=gen8) * e8**-0.5).to(device)
        w28 = (torch.randn((n8, e8), generator=gen8) * n8**-0.5).to(device)
        cases[f"K8@{sub}"] = (
            fused.mlp_ln_bwd, fused.mlp_ln_bwd_plain,
            lambda dt, a=(x8, w18, w28, g8): (a[0].to(dt), a[1], a[2], a[3].to(dt)),
            lambda es, r8=r8, e8=e8, n8=n8: (12 * r8 * e8 * n8, 3 * r8 * e8 * es + 2 * e8 * n8 * (es + 4)))
    # K10 at the other widths of its row pass, on groups its units straddle,
    # with heads across its chunks and at h·d = 256; random o, as K10 takes
    # any attention output
    gen10 = torch.Generator().manual_seed(10)
    for sub, ((n_grp, n_seq), e10, h10, d10) in K10_CASES.items():
        hd10 = h10 * d10
        x10, gr10, o10 = (torch.randn((n_grp, n_seq, w), generator=gen10).to(device) for w in (e10, e10, hd10))
        w10 = (torch.randn((h10, d10, e10), generator=gen10) * hd10**-0.5).to(device)
        cases[f"K10@{sub}"] = (
            item_fused.item_epilogue_bwd, item_fused.item_epilogue_bwd_plain,
            lambda dt, a=(x10, o10, w10, gr10): (a[0].to(dt), a[1].to(dt), a[2], a[3].to(dt)),
            k10_work(n_grp * n_seq, e10, hd10, n_grp * h10 * n_seq))
    libraries = {"K9": item_sdpa_bwd} | {kid: flash_sdpa_bwd(*blk) for kid, blk in blocks.items()}
    seqs = bwd_products(dims)
    seqs["K7s"] = seqs["K7"]
    # a package without `mlp_bwd_body` (before K8's row pass) runs the
    # sequence, as does this one at widths the row pass does not take
    if not (hasattr(fused, "mlp_bwd_body") and fused.mlp_bwd_body(torch.bfloat16, e, nhid) == "wgmma"):
        seqs["K8"] = seqs["K8 sequence"]
    # the same for K10 (`item_epilogue_bwd_body`, before its row pass)
    if not (hasattr(item_fused, "item_epilogue_bwd_body")
            and item_fused.item_epilogue_bwd_body(torch.bfloat16, e, hd, d) == "wgmma"):
        seqs["K10"] = seqs["K10 sequence"]
    results = {}
    for kid, (kern, plain, make, work) in cases.items():
        if only is not None and kid.split("@")[0] not in only:
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
    """K7's, K7s', K8's or K10's bf16 launch sequence: each launch's device
    time by profiler name, each product's ``torch.matmul`` time (a row
    pass's products on chip too), each launch's bytes over the HBM rate (and
    the FLOPs of a row pass over the bf16 peak),
    all printed; the two measured ones are returned as
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
        if "products" in ln:  # the row pass: its products at the bf16 peak, recompute included
            flops = sum(2 * p["M"] * p["N"] * p["K"] for p in ln["products"])
            on_mm = ", ".join(f"{p['name']} {mm[p['name']]:.4f}" for p in ln["products"] if p["name"] in mm)
            shape = (f" ({len(ln['products'])} products on chip, {len(ln['recomputed'])} recomputed: "
                     f"ops bound {flops / PEAK_FLOPS['bf16'] * 1e3:.4f} ms"
                     + (f"; torch.matmul on them (ms): {on_mm}" if on_mm else "") + ")")
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


def phase_finetune(device, model_path, data, steps, n_layers, out_path, flash_dims=None,
                   task="multiclass") -> dict:
    """``fine_tune_mmpfn`` on the flagship in bf16, validation after every
    step, with the launch counters zeroed just before and read just after:
    every training step runs K7, K8, K9 and K10 once per layer. A
    "regression" ``task`` fine-tunes a regressor (validated by rmse) and
    serves the snapshot with ``MMPFNRegressor``. With
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
    regression = task == "regression"
    kernels.reset_launches()
    if flash:
        sample_major_grad(device, flash_dims)
    t0 = time.perf_counter()
    hist = fine_tune_mmpfn(
        mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8, features_per_group=1,
        X_train=X, image_train=img, y_train=y, path_to_base_model=str(model_path),
        save_path_to_fine_tuned_model=str(out_path), finetuning_config={"max_steps": steps},
        device=str(device), random_seed=0, task_type=task,
        validation_metric="rmse" if regression else "log_loss",
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
        # (and K7s) launch; every K8 and K10 launch was the row pass
        check_wgmma_bodies("fine-tune", launches, bodies, ("K2b",) + FEAT_IDS + ("K7", "K7s", "K8", "K10"))
    print(f"  feature attention, K2b, K7's per-row attention, K8 and K10 by body "
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
    if regression:
        check(snap_model.criterion_borders is not None
              and np.array_equal(snap_model.criterion_borders, base_model.criterion_borders),
              "the regression snapshot lost the base model's borders")
    moved = max(float((snap[k].float() - base[k].float()).abs().max()) for k in base)
    print(f"  validation improved: {improved}; the snapshot differs from the base model by "
          f"{moved:.3e} (max abs)", flush=True)
    check((moved > 0) == improved, "the snapshot on disk is not the best one of the run")
    n_tr = int(round(0.8 * len(X)))
    est = (make_regressor if regression else make_classifier)(device, out_path)
    est.fit(X[:n_tr], img[:n_tr], y[:n_tr])
    kernels.reset_launches()
    if regression:
        check_regression(est.predict(X[n_tr:], img[n_tr:], output_type="full"), len(X) - n_tr,
                         float(np.std(y[:n_tr])), "fine-tuned regression snapshot")
    else:
        check_proba(est.predict_proba(X[n_tr:], img[n_tr:]), len(X) - n_tr, est.n_classes_,
                    "fine-tuned snapshot")
    served = dict(kernels.LAUNCHES)
    if device.type == "cuda" and flash:
        check(served["K4"] >= 2 * L and served["K2a"] == 0,
              f"the snapshot was not served through K4: {served}")
    print(f"  the best snapshot ({out_path.name}, multiquery test block {mq}) served by "
          + (f"MMPFNRegressor: predict({len(X) - n_tr} rows) finite, quantiles monotone"
             if regression else f"MMPFNClassifier: predict_proba({len(X) - n_tr} rows) rows sum to 1")
          + (f", K4 launched {served['K4']} times, K2a {served['K2a']}" if flash else ""), flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return dict(launches=launches, hist=hist, warm_step_ms=warm, wall_s=wall)


def episode_trainer(device, model_path, data, n_layers, compute_dtype, use_kernels, seed=0,
                    override=None, task="multiclass"):
    """`fine_tune_mmpfn`'s step loop (`train/finetune.make_episode_trainer`)
    on the flagship's train split: the model cut to its first ``n_layers``,
    the kernels on or off, and ``override``'s config fields."""
    import numpy as np

    from multimodalpfn_tpu_torch.train.finetune import create_val_data, make_episode_trainer

    X, img, y = data
    X_tr, _, i_tr, _, y_tr, _ = create_val_data(X=X, image=img, y=y, rng=np.random.RandomState(seed),
                                                is_classification=task != "regression")
    return make_episode_trainer(
        path_to_base_model=str(model_path), mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8,
        features_per_group=1, X_train=X_tr, image_train=i_tr, y_train=y_tr, device=device, task=task,
        random_seed=seed, compute_dtype=compute_dtype,
        cfg_override=dict(nlayers=n_layers, fused_ops=use_kernels, use_flash=use_kernels)
        | (override or {}),
    )


def phase_finetune_kernel_vs_plain(device, model_path, data, n_layers, steps=3, override=None,
                                   expect=None, task="multiclass") -> dict:
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
                                  override=override if use_kernels else None, task=task)
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


def sweep(device, model_path, data, cells, steps, lr=1e-5, mixer_type="MGM+CAP", compute_dtype=None,
          override=None, mesh=None) -> dict:
    """`train/finetune_batch.fine_tune_batched_cells` on the flagship data,
    validation after every step (its runs over ``mesh``'s ``dp`` axis when
    one is given)."""
    from multimodalpfn_tpu_torch.train.finetune_batch import fine_tune_batched_cells

    X, img, y = data
    return fine_tune_batched_cells(
        cells=cells, mixer_type=mixer_type, features_per_group=1, path_to_base_model=str(model_path),
        X=X, image=img, y=y, finetuning_config={"max_steps": steps, "learning_rate": lr},
        device=str(device), compute_dtype=compute_dtype, cfg_override=override, mesh=mesh,
    )


def check_sweep_history(out: dict, steps: int, tag: str) -> None:
    import numpy as np

    hist, n_runs = out["history"], len(out["run_cells"])
    loss = np.asarray(hist["train_loss"])
    errs = np.asarray([e for _, e in hist["val_error"]])
    check(loss.shape == (steps, n_runs), f"{tag}: train losses of shape {loss.shape}")
    check(bool(np.isfinite(loss).all() and np.isfinite(errs).all()), f"{tag}: a non-finite loss or error")
    check(hist["skipped_steps"] == [0] * n_runs, f"{tag}: skipped steps {hist['skipped_steps']}")


def phase_sweep(device, model_path, data, steps, n_layers, out_dir: Path) -> dict:
    """The sweep served by the kernels: `SWEEP_CELLS` (4 runs, mixers padded
    to 32 heads) for ``steps`` bf16 steps at lr 1e-5, validation after every
    step, with the launch counters zeroed just before and read just after:
    every run's step runs K1, K2a, K2b and K3 forward in every layer (and so
    does each of the steps + 1 validations), K7, K8, K9 and K10 backward,
    each K1, K2b, K3 launch and K7's per-row attention on the wgmma body;
    every loss and validation error finite. The sweep step's time on the
    host clock (all runs' steps and validations, ended by a device
    synchronize) is printed per step and per run. Then the mgm-16 runs'
    params (`extract_run_params`) are saved and served by the classifier."""
    import numpy as np
    import torch

    from multimodalpfn_tpu_torch.models.loading import save_model
    from multimodalpfn_tpu_torch.ops import kernels
    from multimodalpfn_tpu_torch.train.finetune_batch import extract_run_params

    kernels.reset_launches()
    t0 = time.perf_counter()
    out = sweep(device, model_path, data, SWEEP_CELLS, steps)
    wall = time.perf_counter() - t0
    launches, bodies = dict(kernels.LAUNCHES), dict(kernels.BODY_LAUNCHES)
    hist, n_runs, L = out["history"], len(out["run_cells"]), n_layers
    step_ms = [t * 1e3 for t in hist["step_seconds"]]
    warm = float(np.median(step_ms[1:])) if len(step_ms) > 1 else step_ms[0]
    loss = np.asarray(hist["train_loss"])
    print(f"  {n_runs} runs (cells {[(c['mgm_heads'], c['cap_heads']) for c in SWEEP_CELLS]} x seeds "
          f"{SWEEP_CELLS[0]['seeds']}, padded to {out['config'].mixer.mgm_heads} heads) x {steps} steps in "
          f"{wall:.1f} s; sweep step (every run's step and validation): first {step_ms[0]:.1f} ms, warm "
          f"median {warm:.1f} ms = {warm / n_runs:.1f} ms per run; train loss per run "
          f"{np.round(loss[0], 5).tolist()} -> {np.round(loss[-1], 5).tolist()}; best validation error "
          f"{np.round(hist['best_val_error'], 5).tolist()}", flush=True)
    print(f"  launches {launches} (K1, K2a, K2b, K3 = {n_runs} x ({steps} + {steps + 1}) x {L}; K7, K8, K9, "
          f"K10 = {n_runs} x {steps} x {L})", flush=True)
    check_sweep_history(out, steps, "sweep")
    if device.type == "cuda":
        exact = ({kid: n_runs * (2 * steps + 1) * L for kid in ("K1", "K2a", "K2b", "K3")}
                 | {kid: n_runs * steps * L for kid in ("K7", "K8", "K9", "K10")}
                 | {kid: 0 for kid in ("K4", "K5", "K6a", "K6b", "K7s", "K11")})
        for kid, n in exact.items():
            check(launches[kid] == n, f"{kid} launched {launches[kid]} times in the sweep, expected {n}")
        check_wgmma_bodies("sweep", launches, bodies, ("K2b", "K3", "K7", "K8", "K10") + FEAT_IDS)
    n_tr = int(round(0.8 * len(data[2])))
    X, img, y = data
    served = []
    for r, (ci, seed) in enumerate(out["run_cells"]):
        if SWEEP_CELLS[ci]["mgm_heads"] != 16:
            continue
        params_r, cfg_r = extract_run_params(out, r)
        check(cfg_r.mixer.mgm_heads == 16 and params_r["mixer"]["mgm"]["w1"].shape[0] == 16,
              "extract_run_params did not return the cell's 16 heads")
        path = out_dir / f"chip_smoke_sweep_m16_seed{seed}.ckpt"
        save_model(path, params_r, cfg_r)
        clf = make_classifier(device, path)
        clf.fit(X[:n_tr], img[:n_tr], y[:n_tr])
        check_proba(clf.predict_proba(X[n_tr:], img[n_tr:]), len(X) - n_tr, clf.n_classes_,
                    f"the sweep's run {r} served")
        served.append(path.name)
    print(f"  the mgm-16 runs saved at their true shape and served by MMPFNClassifier "
          f"({len(X) - n_tr} rows, rows sum to 1): {served}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return dict(launches=launches, hist=hist, warm_step_ms=warm, per_run_ms=warm / n_runs, wall_s=wall)


def compare_sweeps(got: dict, want: dict, runs=None) -> tuple[float, float, float]:
    """Train losses (relative), all params (absolute) and the mixers
    (absolute) of ``got``'s runs ``runs`` against ``want``'s runs, each
    extracted at its cell's shape."""
    import numpy as np

    from multimodalpfn_tpu_torch.models.params import flatten_params
    from multimodalpfn_tpu_torch.train.finetune_batch import extract_run_params

    runs = list(range(len(want["run_cells"]))) if runs is None else runs
    lg = np.asarray(got["history"]["train_loss"])[:, runs]
    lw = np.asarray(want["history"]["train_loss"])
    loss_rel = float(np.max(np.abs(lg - lw) / np.abs(lw)))
    param_err = mixer_err = 0.0
    for r_got, r_want in zip(runs, range(lw.shape[1])):
        pg = flatten_params(extract_run_params(got, r_got)[0])
        pw = flatten_params(extract_run_params(want, r_want)[0])
        check(pg.keys() == pw.keys(), "the two sweeps' runs have different leaves")
        for k in pw:
            err = float((pg[k].double() - pw[k].double()).abs().max())
            param_err = max(param_err, err)
            if k.startswith("mixer/"):
                mixer_err = max(mixer_err, err)
    return loss_rel, param_err, mixer_err


def phase_sweep_f32(device, model_path, data, n_layers) -> dict:
    """Float32 gates of the sweep on the first ``n_layers`` layers.
    (a) Three steps of `SWEEP_CELLS` on the kernel path against the plain
    path: losses within `FT_STEP_REL_BOUND` relative, params within
    `FT_PARAM_ABS_BOUND`; the plain path launches no kernel. (b) Padded equals
    unpadded: the two cells in one sweep against each alone, two steps on the
    kernel path: at lr `SWEEP_TINY_LR` the losses within
    `SWEEP_LOSS_REL_BOUND` relative and the extracted mixers within
    `SWEEP_MIXER_ABS_BOUND`; at lr 1e-5 the losses within
    `FT_STEP_REL_BOUND`. (c) A padded MGM group (`SWEEP_MGM_CELLS`): two bf16
    steps launch K2a, K2b, K9 and K10 and no K1, K3, K7 or K8 (its feature
    attention is masked, so plain, as is its MLP); its float32 kernel path
    matches its plain path within (a)'s bounds."""
    import numpy as np

    from multimodalpfn_tpu_torch.ops import kernels

    L = n_layers
    kern, plain = {"nlayers": L}, {"nlayers": L, "fused_ops": False, "use_flash": False}
    out = {}
    runs = {}
    for name, override in (("kernel", kern), ("plain", plain)):
        kernels.reset_launches()
        runs[name] = (sweep(device, model_path, data, SWEEP_CELLS, 3, compute_dtype="float32",
                            override=override), dict(kernels.LAUNCHES))
    (k, lk), (pl, lp) = runs["kernel"], runs["plain"]
    loss_rel, param_err, _ = compare_sweeps(k, pl)
    print(f"  (a) {len(k['run_cells'])} runs x 3 float32 steps, {L} layers: losses kernel "
          f"{np.round(k['history']['train_loss'], 6).tolist()} plain "
          f"{np.round(pl['history']['train_loss'], 6).tolist()}; loss rel err {loss_rel:.3e} (bound "
          f"{FT_STEP_REL_BOUND}), params max abs err {param_err:.3e} (bound {FT_PARAM_ABS_BOUND})", flush=True)
    check(loss_rel <= FT_STEP_REL_BOUND, f"sweep kernel path losses differ from the plain path by {loss_rel:.3e}")
    check(param_err <= FT_PARAM_ABS_BOUND, f"sweep kernel path params differ from the plain path by {param_err:.3e}")
    if device.type == "cuda":
        n = len(k["run_cells"]) * 3 * L
        for kid in ("K7", "K8", "K9", "K10"):
            check(lk[kid] == n, f"{kid} launched {lk[kid]} times on the sweep's kernel path, expected {n}")
        check(not any(lp.values()), f"the sweep's plain path launched kernels: {lp}")
    out["a"] = dict(loss_rel=loss_rel, param_err=param_err)

    for lr, bound in ((SWEEP_TINY_LR, SWEEP_LOSS_REL_BOUND), (1e-5, FT_STEP_REL_BOUND)):
        both = sweep(device, model_path, data, SWEEP_CELLS, 2, lr=lr, compute_dtype="float32", override=kern)
        worst = [0.0, 0.0]
        for ci, cell in enumerate(SWEEP_CELLS):
            alone = sweep(device, model_path, data, [cell], 2, lr=lr, compute_dtype="float32", override=kern)
            idx = [r for r, (c, _) in enumerate(both["run_cells"]) if c == ci]
            loss_rel, _, mixer_err = compare_sweeps(both, alone, idx)
            worst = [max(worst[0], loss_rel), max(worst[1], mixer_err)]
        print(f"  (b) lr {lr:g}: cells {[c['mgm_heads'] for c in SWEEP_CELLS]} in one sweep against each "
              f"alone: loss rel err {worst[0]:.3e} (bound {bound}), extracted mixers max abs err "
              f"{worst[1]:.3e}" + (f" (bound {SWEEP_MIXER_ABS_BOUND})" if lr == SWEEP_TINY_LR else ""),
              flush=True)
        check(worst[0] <= bound, f"padded and unpadded losses differ by {worst[0]:.3e} at lr {lr:g}")
        if lr == SWEEP_TINY_LR:
            check(worst[1] <= SWEEP_MIXER_ABS_BOUND, f"padded and unpadded mixers differ by {worst[1]:.3e}")
        out[f"b_lr{lr:g}"] = dict(loss_rel=worst[0], mixer_err=worst[1])

    kernels.reset_launches()
    mgm = sweep(device, model_path, data, SWEEP_MGM_CELLS, 2, mixer_type="MGM", override=kern)
    lm = dict(kernels.LAUNCHES)
    check_sweep_history(mgm, 2, "padded MGM sweep")
    n_runs = len(mgm["run_cells"])
    print(f"  (c) padded MGM group {[c['mgm_heads'] for c in SWEEP_MGM_CELLS]} x seeds "
          f"{SWEEP_MGM_CELLS[0]['seeds']}, 2 bf16 steps: launches { {k: v for k, v in lm.items() if v} } "
          f"(K2a, K2b = {n_runs} x (2 + 3) x {L}; K9, K10 = {n_runs} x 2 x {L}; no K1, K3, K7, K8)", flush=True)
    if device.type == "cuda":
        exact = ({kid: n_runs * 5 * L for kid in ("K2a", "K2b")} | {kid: n_runs * 2 * L for kid in ("K9", "K10")}
                 | {kid: 0 for kid in ("K1", "K3", "K7", "K8", "K5", "K6a", "K6b", "K7s", "K4", "K11")})
        for kid, n in exact.items():
            check(lm[kid] == n, f"{kid} launched {lm[kid]} times in the padded MGM sweep, expected {n}")
    mk = sweep(device, model_path, data, SWEEP_MGM_CELLS, 2, mixer_type="MGM", compute_dtype="float32",
               override=kern)
    mp = sweep(device, model_path, data, SWEEP_MGM_CELLS, 2, mixer_type="MGM", compute_dtype="float32",
               override=plain)
    loss_rel, param_err, _ = compare_sweeps(mk, mp)
    print(f"  (c) its float32 kernel path against its plain path: loss rel err {loss_rel:.3e}, params max "
          f"abs err {param_err:.3e}", flush=True)
    check(loss_rel <= FT_STEP_REL_BOUND and param_err <= FT_PARAM_ABS_BOUND,
          f"the padded MGM sweep's kernel path differs from its plain path: {loss_rel:.3e}, {param_err:.3e}")
    out["c"] = dict(launches=lm, loss_rel=loss_rel, param_err=param_err)
    return out


def phase_study(device, model_path, data, steps, out_dir: Path) -> dict:
    """The grid study: `hpo/experiment.run_experiment_cross_cell` over mgm
    {4, 16, 32} × cap {8}, 2 seeds, ``steps`` steps (the mgm-16 and mgm-32
    cells in one sweep), checkpoints under ``out_dir``, then
    `run_experiment` on the mgm-16 cell for 1 seed and 2 steps; the launch
    counters zeroed before each and read after. mgm 4 is pruned, every other
    trial complete with all its seeds and an accuracy in [0, 1], none
    failed; the study JSON round-trips."""
    import json

    from multimodalpfn_tpu_torch.hpo.experiment import run_experiment, run_experiment_cross_cell
    from multimodalpfn_tpu_torch.ops import kernels

    X, img, y = data
    common = dict(X=X, embeddings=img, y=y, n_categorical=18, dataset_name="chip_smoke",
                  path_to_base_model=str(model_path), checkpoint_dir=str(out_dir / "chip_smoke_study"),
                  device=str(device))
    results = out_dir / "chip_smoke_study.json"
    results.unlink(missing_ok=True)
    out = {}
    for name, run in (
        ("cross_cell", lambda: run_experiment_cross_cell(
            config={"mgm_heads_list": [4, 16, 32], "cap_heads_list": [8], "mixer_type": "MGM+CAP",
                    "features_per_group": 1}, n_seeds=2, results_path=str(results),
            finetuning_config={"max_steps": steps}, **common)),
        ("sequential", lambda: run_experiment(
            config={"mgm_heads_list": [16], "cap_heads_list": [8], "mixer_type": "MGM+CAP",
                    "features_per_group": 1}, n_seeds=1, finetuning_config={"max_steps": 2}, **common)),
    ):
        kernels.reset_launches()
        t0 = time.perf_counter()
        study = run()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        table = [(t.params["mgm_heads"], t.params["cap_heads"], t.state, t.value,
                  t.user_attrs.get("n_completed_seeds"), t.user_attrs.get("error")) for t in study.trials]
        print(f"  {name}: {wall:.1f} s; trials (mgm, cap, state, accuracy, seeds, error) {table}; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        n_seeds = 2 if name == "cross_cell" else 1
        for m, c, state, value, seeds, error in table:
            check(state != "failed", f"{name}: trial mgm {m} cap {c} failed: {error}")
            if m < c:
                check(state == "pruned", f"{name}: trial mgm {m} cap {c} is {state}, not pruned")
                continue
            check(state == "complete" and seeds == n_seeds and 0.0 <= value <= 1.0,
                  f"{name}: trial mgm {m} cap {c}: {state}, {seeds} seeds, accuracy {value}")
        if device.type == "cuda":
            for kid in ("K1", "K2a", "K2b", "K3", "K7", "K8", "K9", "K10"):
                check(launches[kid] > 0, f"{name}: {kid} was not launched")
        out[name] = dict(trials=table, launches=launches, wall_s=wall)
    saved = json.loads(results.read_text())
    check([(t["params"]["mgm_heads"], t["state"], t["value"]) for t in saved["trials"]]
          == [(m, state, value) for m, _, state, value, _, _ in out["cross_cell"]["trials"]],
          "the study JSON does not round-trip")
    print(f"  the study JSON ({results.name}) round-trips", flush=True)
    return out


def phase_dinov2(device, model_path, data, vit_cfg, img_size: int, batch: int, n_train: int) -> dict:
    """DINOv2 ViT-B/14 through its public entry point: `modal/dinov2.embed_images`
    over one image per row of ``data`` (pixels uniform in [0, 1), drawn batch
    by batch from a numpy generator, so the whole image set is never held),
    random weights from `init_vit_params` (seed 0). The launch counters,
    zeroed just before, must show K4 once a block of every batch and no other
    kernel; the embeddings finite. Then the served classifier fits the first
    ``n_train`` rows with these embeddings in place of the synthetic ones and
    answers the rest, checked as phase 3's requests."""
    import numpy as np
    import torch

    from multimodalpfn_tpu_torch.modal import dinov2
    from multimodalpfn_tpu_torch.ops import kernels

    X, _, y = data
    n = len(X)
    params = dinov2.init_vit_params(torch.Generator().manual_seed(0), vit_cfg)
    params = dinov2.prepare_params(params, vit_cfg, device)
    rng = np.random.default_rng(0)
    embs, batch_ms, draw_s = [], [], 0.0
    kernels.reset_launches()
    t_start = time.perf_counter()
    for i in range(0, n, batch):
        t0 = time.perf_counter()
        imgs = rng.random((min(batch, n - i), 1, 3, img_size, img_size), dtype=np.float32)
        t1 = time.perf_counter()
        embs.append(dinov2.embed_images(params, vit_cfg, imgs, batch_size=batch, device=device))
        batch_ms.append((time.perf_counter() - t1) * 1e3)
        draw_s += t1 - t0
    wall = time.perf_counter() - t_start
    launches = dict(kernels.LAUNCHES)
    emb = np.concatenate(embs)
    n_batches = len(batch_ms)
    warm = float(np.median(batch_ms[1:-1])) if n_batches > 2 else batch_ms[-1]
    print(f"  {n} images at {img_size} px in {n_batches} batches of {batch}: embed_images {sum(batch_ms):.1f} "
          f"ms in all (first batch {batch_ms[0]:.1f} ms, warm batch median {warm:.2f} ms, min "
          f"{min(batch_ms):.2f}), {wall:.2f} s with drawing the pixels ({draw_s:.2f} s); launches "
          f"{ {k: v for k, v in launches.items() if v} } (K4 expected {n_batches * vit_cfg.depth})",
          flush=True)
    check(emb.shape == (n, 1, vit_cfg.embed_dim) and bool(np.isfinite(emb).all()),
          f"DINOv2 embeddings of shape {emb.shape}, finite {bool(np.isfinite(emb).all())}")
    if device.type == "cuda":
        check(launches["K4"] == n_batches * vit_cfg.depth,
              f"K4 launched {launches['K4']} times, not {n_batches * vit_cfg.depth}")
        others = {k: v for k, v in launches.items() if k != "K4" and v}
        check(not others, f"DINOv2 launched other kernels: {others}")
    print("  the classifier on these embeddings:", flush=True)
    served = phase_served(device, model_path, (X[:n_train], emb[:n_train], y[:n_train], X[n_train:],
                                               emb[n_train:]), [n - n_train], 12, "fit_preprocessors")
    return dict(launches=launches, batch_ms=batch_ms, warm_batch_ms=warm, embed_ms=sum(batch_ms),
                wall_s=wall, served=served, emb=emb)


def phase_encoder_gates(device, vit_cfg, img_size: int, batch: int, electra_cfg, n_seq: int, seq_len: int,
                        short_len: int) -> dict:
    """DINOv2's kernel path against its plain path (`embed_images` with
    ``use_kernels=False``: the plain attention on the card) on one batch at
    ``vit_cfg``'s width, in float32 and bf16; then ELECTRA (`cls_embeddings`,
    float32, random weights) on ``n_seq`` random sequences padded from random
    lengths to ``short_len`` tokens: finite, the same CLS with ``seq_len -
    short_len`` more padding tokens appended and with batches of 5 in place of
    16, and no kernel launched (its masked attention is plain PyTorch)."""
    import dataclasses

    import numpy as np
    import torch

    from multimodalpfn_tpu_torch.modal import dinov2, electra
    from multimodalpfn_tpu_torch.ops import kernels

    params = dinov2.init_vit_params(torch.Generator().manual_seed(1), vit_cfg)
    imgs = np.random.default_rng(1).random((batch, 1, 3, img_size, img_size), dtype=np.float32)
    out = {}
    for cd, bound in (("float32", VIT_F32_REL_BOUND), ("bfloat16", BF16_REL_BOUND)):
        cfg = dataclasses.replace(vit_cfg, compute_dtype=cd)
        got = dinov2.embed_images(params, cfg, imgs, batch_size=batch, device=device)
        want = dinov2.embed_images(params, cfg, imgs, batch_size=batch, device=device, use_kernels=False)
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        out[f"dinov2_rel_{cd}"] = rel
        print(f"  DINOv2 {cd}, {batch} images: kernel path against plain path, largest CLS difference "
              f"{rel:.3e} of the largest CLS value (bound {bound:.1e})", flush=True)
        check(bool(np.isfinite(got).all()), f"DINOv2 {cd}: non-finite embeddings")
        check(rel <= bound, f"DINOv2 {cd}: kernel path differs from the plain path by {rel:.3e}")

    eparams = electra.init_params(torch.Generator().manual_seed(2), electra_cfg)
    rng = np.random.default_rng(2)
    lengths = rng.integers(8, short_len + 1, n_seq)
    mask = (np.arange(seq_len)[None] < lengths[:, None]).astype(np.int64)
    ids = np.where(mask == 1, rng.integers(1, electra_cfg.vocab_size, (n_seq, seq_len)), 0)
    kernels.reset_launches()
    t0 = time.perf_counter()
    cls = electra.cls_embeddings(eparams, electra_cfg, ids[:, :short_len], mask[:, :short_len],
                                 batch_size=16, device=device)
    ms = (time.perf_counter() - t0) * 1e3
    longer = electra.cls_embeddings(eparams, electra_cfg, ids, mask, batch_size=16, device=device)
    rebatched = electra.cls_embeddings(eparams, electra_cfg, ids[:, :short_len], mask[:, :short_len],
                                       batch_size=5, device=device)
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    scale = float(np.abs(cls).max())
    pad_rel = float(np.abs(longer - cls).max()) / scale
    batch_rel = float(np.abs(rebatched - cls).max()) / scale
    out |= dict(electra_pad_rel=pad_rel, electra_batch_rel=batch_rel, electra_ms=ms)
    print(f"  ELECTRA ({electra_cfg.hidden} wide, {electra_cfg.layers} layers, float32), {n_seq} sequences "
          f"of {lengths.min()}-{lengths.max()} tokens padded to {short_len}: {ms:.1f} ms (first call); "
          f"padded to {seq_len}: CLS moved by {pad_rel:.2e} of the largest; batches of 5: {batch_rel:.2e} "
          f"(bound {ELECTRA_REL_BOUND:.0e}); launches {launched}", flush=True)
    check(cls.shape == (n_seq, 1, electra_cfg.hidden) and bool(np.isfinite(cls).all()),
          f"ELECTRA CLS of shape {cls.shape}, finite {bool(np.isfinite(cls).all())}")
    check(pad_rel <= ELECTRA_REL_BOUND, f"ELECTRA: appended padding moved the CLS by {pad_rel:.2e}")
    check(batch_rel <= ELECTRA_REL_BOUND, f"ELECTRA: another batch size moved the CLS by {batch_rel:.2e}")
    check(not launched, f"ELECTRA launched kernels: {launched}")
    return out


def regression_target(X, codes):
    """The regression target of the regressor's phases: the class code, half
    of feature 18 (NaN as 0) and lognormal noise (σ = 0.5) from
    ``default_rng(1)``, a skewed target on which the safepower target
    transform has work."""
    import numpy as np

    noise = np.random.default_rng(1).lognormal(sigma=0.5, size=len(codes))
    return codes + 0.5 * np.nan_to_num(X[:, 18]) + noise


def write_regression_model(path: Path) -> None:
    """The served regressor: the published 192×12 architecture with MGM+CAP
    16/8, ``max_num_classes`` 0, 5000 bars over ``linspace(-12, 12, 5001)``,
    random weights from seed 0 densified from seed 1 (as `write_model`), as
    an ``.npz`` that carries the borders."""
    from multimodalpfn_tpu_torch.models.loading import load_model, save_npz

    loaded = load_model("random:0", which="regressor", mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8)
    densify(loaded.params, seed=1)
    path.parent.mkdir(parents=True, exist_ok=True)
    save_npz(path, loaded.params, loaded.config, criterion_borders=loaded.criterion_borders)


def make_regressor(device, model_path, **kw):
    """The served regressor: 4 members, the regressor's default
    preprocessing and target transforms (None, safepower)."""
    from multimodalpfn_tpu_torch import MMPFNRegressor

    return MMPFNRegressor(model_path=str(model_path), mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8,
                          n_estimators=4, device=str(device), **kw)


def check_regression(full: dict, n_rows: int, scale: float, tag: str) -> None:
    """A ``predict(output_type="full")`` answer: mean, median, mode and the
    nine quantiles finite, of ``n_rows``; the quantiles monotone and the
    median between the 0.1 and 0.9 quantiles, to `REG_MONOTONE_SLACK` of
    ``scale`` (std(y_train))."""
    import numpy as np

    for key in ("mean", "median", "mode"):
        check(full[key].shape == (n_rows,), f"{tag}: {key} shape {full[key].shape}")
        check(bool(np.isfinite(full[key]).all()), f"{tag}: non-finite {key}")
    q = np.stack(full["quantiles"])
    check(q.shape == (9, n_rows) and bool(np.isfinite(q).all()), f"{tag}: quantiles {q.shape} not finite")
    slack = REG_MONOTONE_SLACK * scale
    check(bool((np.diff(q, axis=0) >= -slack).all()), f"{tag}: the quantiles are not monotone")
    check(bool(((full["median"] >= q[0] - slack) & (full["median"] <= q[-1] + slack)).all()),
          f"{tag}: a median lies outside its 0.1 and 0.9 quantiles")


def phase_regressor_served(device, model_path, data, request_sizes, n_layers, fit_mode) -> dict:
    """The regressor through the public API in bf16: fit, then the three
    ``predict(output_type="full")`` requests with the launch counters zeroed
    just before (fit_with_cache: before the fit) and checked as the
    classifier's (`check_served_launches`); every answer checked by
    `check_regression`; then the same requests warm, each timed on the host
    clock in two parts: the dispatch and the engine's fetch of the member
    logits (host transforms, uploads, the forward, the copy back), and the
    host finalize (`MMPFNRegressor.predict_from_outputs`: border transforms,
    translation, average, statistics). fit_with_cache: ``predict_many`` over
    the requests equals the sequential answers bit for bit."""
    import numpy as np
    import torch

    from multimodalpfn_tpu_torch.ops import kernels

    X_tr, img_tr, y_tr, X_te, img_te = data
    scale = float(np.std(y_tr))
    cached = fit_mode == "fit_with_cache"
    reg = make_regressor(device, model_path, fit_mode=fit_mode)
    if cached:
        kernels.reset_launches()
    t0 = time.perf_counter()
    reg.fit(X_tr, img_tr, y_tr)
    if device.type == "cuda":
        torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    members = reg.executor_.members
    widths = [m.X_train.shape[1] for m in members]
    transforms = [None if m.config.target_transform is None else "safepower" for m in members]
    plans = planned_groups(reg, cached, request_sizes)
    print(f"  fit {fit_ms:.1f} ms; member widths {widths}, target transforms {transforms}; planned "
          f"groups {[(idxs, w, 'merged' if m else 'one width') for idxs, w, m in plans]}", flush=True)
    check(transforms.count("safepower") == 2, f"the members' target transforms are {transforms}")

    if not cached:
        kernels.reset_launches()
    times, answers = [], []
    for n in request_sizes:
        t0 = time.perf_counter()
        full = reg.predict(X_te[:n], img_te[:n], output_type="full")
        times.append((time.perf_counter() - t0) * 1e3)
        check_regression(full, n, scale, f"regressor request of {n} rows")
        answers.append(full)
        print(f"  predict({n} rows, full): {times[-1]:.1f} ms; mean of the means {full['mean'].mean():.4f}"
              f" (y_train mean {float(np.mean(y_tr)):.4f}, std {scale:.4f})", flush=True)
    launches = check_served_launches(device, fit_mode, plans, len(request_sizes), n_layers)
    warm, device_part, host_part, stats_part = [], [], [], []
    crit = reg.renormalized_criterion_
    for n in request_sizes:
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        outputs = reg.executor_.finalize_outputs(reg._dispatch_predict(X_te[:n], img_te[:n]))
        t1 = time.perf_counter()
        full = reg.predict_from_outputs(outputs, output_type="full")
        t2 = time.perf_counter()
        # the statistics alone, recomputed from the averaged log-probabilities
        logits = torch.from_numpy(full["logits"])
        crit.mean(logits), crit.median(logits), crit.mode(logits)
        [crit.icdf(logits, q) for q in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)]
        stats_part.append((time.perf_counter() - t2) * 1e3)
        device_part.append((t1 - t0) * 1e3)
        host_part.append((t2 - t1) * 1e3)
        warm.append((t2 - t0) * 1e3)
    print(f"  warm requests: {', '.join(f'{ms:.1f}' for ms in warm)} ms = dispatch + forward + fetch "
          f"{', '.join(f'{ms:.1f}' for ms in device_part)} ms + host finalize "
          f"{', '.join(f'{ms:.1f}' for ms in host_part)} ms (of which the statistics "
          f"{', '.join(f'{ms:.1f}' for ms in stats_part)} ms; the rest the border transforms, the "
          f"translation and the average)", flush=True)
    out = dict(launches=launches, fit_ms=fit_ms, times=times, warm=warm, warm_device=device_part,
               warm_host=host_part, warm_stats=stats_part, answers=answers, widths=widths, plans=plans)
    if cached:
        reqs = [(X_te[:n], img_te[:n]) for n in request_sizes]
        t0 = time.perf_counter()
        many = reg.predict_many([r[0] for r in reqs], [r[1] for r in reqs], output_type="full")
        out["many_ms"] = (time.perf_counter() - t0) * 1e3
        same = all(np.array_equal(a[k], b[k]) for a, b in zip(many, answers)
                   for k in ("logits", "mean", "median", "mode", "quantiles"))
        print(f"  predict_many over the {len(reqs)} requests: {out['many_ms']:.1f} ms, equal to the "
              f"sequential answers: {same}", flush=True)
        check(same, "predict_many differs from sequential predict")
    return out


def phase_regressor_kernel_vs_plain(device, model_path, data, **kw) -> dict:
    """float32 ``predict(output_type="full")`` of the kernel path against the
    plain path of the same fitted regressor (fit_preprocessors; ``kw`` to
    `make_regressor`): the averaged bar probabilities within
    `REG_PROBA_ABS_BOUND`, the mean, median and quantiles within
    `REG_STAT_REL_BOUND` of std(y_train)."""
    import numpy as np

    X_tr, img_tr, y_tr, X_te, img_te = data
    scale = float(np.std(y_tr))
    reg = make_regressor(device, model_path, inference_precision="float32", **kw)
    reg.fit(X_tr, img_tr, y_tr)
    answers = {}
    for use_kernels in (True, False):
        reg.executor_.use_kernels = use_kernels
        answers[use_kernels] = reg.predict(X_te, img_te, output_type="full")
        check_regression(answers[use_kernels], len(X_te), scale,
                         f"float32 {'kernel' if use_kernels else 'plain'} path")
    k, p = answers[True], answers[False]
    prob_err = float(np.abs(np.exp(k["logits"]) - np.exp(p["logits"])).max())
    stat_err = {key: float(np.abs(np.stack(k[key]) - np.stack(p[key])).max()) / scale
                for key in ("mean", "median", "quantiles")}
    mode_same = float((k["mode"] == p["mode"]).mean())
    print(f"  f32 regressor kernel vs plain: bar probabilities max abs err {prob_err:.3e} (bound "
          f"{REG_PROBA_ABS_BOUND}); max abs err / std(y) {({kk: f'{v:.3e}' for kk, v in stat_err.items()})}"
          f" (bound {REG_STAT_REL_BOUND}); modes equal {mode_same:.3f} (not gated)", flush=True)
    check(prob_err <= REG_PROBA_ABS_BOUND, f"regressor bar probabilities differ by {prob_err:.3e}")
    check(max(stat_err.values()) <= REG_STAT_REL_BOUND, f"regressor statistics differ: {stat_err}")
    return dict(prob_err=prob_err, stat_err=stat_err)


def target_transforms_of(reg) -> list:
    """Each member's target transform as (class name, output distribution,
    n_quantiles), None for none."""
    return [None if (t := m.config.target_transform) is None else
            (type(t).__name__, getattr(t, "output_distribution", None), getattr(t, "n_quantiles", None))
            for m in reg.executor_.members]


def phase_regressor_targets(device, model_path, data, n_layers) -> dict:
    """The regressor through the public API in bf16 with
    ``REGRESSION_Y_PREPROCESS_TRANSFORMS=(None, name)`` for each name of
    `REG_TARGET_NAMES`: the members' target transforms checked against the
    name (two members with its transform, two with none); one
    ``predict(output_type="full")`` of every test row with the launch
    counters zeroed just before and checked as the classifier's
    (`check_served_launches`), the answer checked by `check_regression`; then
    the same request warm, timed as phase 15 (dispatch, forward and fetch;
    host finalize). For each name of `REG_TARGET_CACHED`, ``fit_with_cache``:
    the counters zeroed before the fit, phase 15's three requests, and
    ``predict_many`` over them equal to the sequential answers bit for bit;
    and its float32 kernel path against the plain path
    (`phase_regressor_kernel_vs_plain`). Returns the launches summed over the
    runs of each mode and the timings by name."""
    import numpy as np
    import torch

    from multimodalpfn_tpu_torch.ops import kernels
    from multimodalpfn_tpu_torch.preprocess.steps import ReshapeFeatureDistributionsStep

    X_tr, img_tr, y_tr, X_te, img_te = data
    scale = float(np.std(y_tr))
    n = len(X_te)
    out = {"launches": dict.fromkeys(kernels.LAUNCHES, 0), "launches_cached": dict.fromkeys(kernels.LAUNCHES, 0),
           "warm_device": {}, "warm_host": {}, "many_ms": {}, "f32": {}}

    def fitted(name, fit_mode):
        reg = make_regressor(device, model_path, fit_mode=fit_mode,
                             inference_config={"REGRESSION_Y_PREPROCESS_TRANSFORMS": (None, name)})
        if fit_mode == "fit_with_cache":
            kernels.reset_launches()
        reg.fit(X_tr, img_tr, y_tr)
        want = ReshapeFeatureDistributionsStep.make_transformer(name, num_examples=len(y_tr), random_state=0)
        want = (type(want).__name__, getattr(want, "output_distribution", None),
                getattr(want, "n_quantiles", None))
        got = target_transforms_of(reg)
        print(f"  {name} ({fit_mode}): member target transforms {got}", flush=True)
        check(got.count(want) == 2 and got.count(None) == 2,
              f"{name}: the members' target transforms are {got}, expected two {want}")
        return reg

    for name in REG_TARGET_NAMES:
        reg = fitted(name, "fit_preprocessors")
        plans = planned_groups(reg, False, [n])
        kernels.reset_launches()
        full = reg.predict(X_te, img_te, output_type="full")
        check_regression(full, n, scale, f"{name}: request of {n} rows")
        launches = check_served_launches(device, "fit_preprocessors", plans, 1, n_layers)
        out["launches"] = {k: v + launches[k] for k, v in out["launches"].items()}
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        outputs = reg.executor_.finalize_outputs(reg._dispatch_predict(X_te, img_te))
        t1 = time.perf_counter()
        reg.predict_from_outputs(outputs, output_type="full")
        t2 = time.perf_counter()
        out["warm_device"][name], out["warm_host"][name] = (t1 - t0) * 1e3, (t2 - t1) * 1e3
        print(f"  {name}: warm request of {n} rows {(t2 - t0) * 1e3:.1f} ms = dispatch + forward + fetch "
              f"{(t1 - t0) * 1e3:.1f} ms + host finalize {(t2 - t1) * 1e3:.1f} ms; mean of the means "
              f"{full['mean'].mean():.4f} (y_train mean {float(np.mean(y_tr)):.4f}, std {scale:.4f})", flush=True)

    sizes = [n, min(128, n), min(300, n)]
    for name in REG_TARGET_CACHED:
        reg = fitted(name, "fit_with_cache")
        plans = planned_groups(reg, True, sizes)
        reqs = [(X_te[:k], img_te[:k]) for k in sizes]
        answers = [reg.predict(*r, output_type="full") for r in reqs]
        for k, full in zip(sizes, answers):
            check_regression(full, k, scale, f"{name} (fit_with_cache): request of {k} rows")
        launches = check_served_launches(device, "fit_with_cache", plans, len(sizes), n_layers)
        out["launches_cached"] = {k: v + launches[k] for k, v in out["launches_cached"].items()}
        t0 = time.perf_counter()
        many = reg.predict_many([r[0] for r in reqs], [r[1] for r in reqs], output_type="full")
        out["many_ms"][name] = (time.perf_counter() - t0) * 1e3
        same = all(np.array_equal(a[k], b[k]) for a, b in zip(many, answers)
                   for k in ("logits", "mean", "median", "mode", "quantiles"))
        print(f"  {name} (fit_with_cache): predict_many over the {len(reqs)} requests "
              f"{out['many_ms'][name]:.1f} ms, equal to the sequential answers: {same}", flush=True)
        check(same, f"{name}: predict_many differs from sequential predict")
        print(f"  {name}: float32 kernel path against plain path", flush=True)
        out["f32"][name] = phase_regressor_kernel_vs_plain(
            device, model_path, data, inference_config={"REGRESSION_Y_PREPROCESS_TRANSFORMS": (None, name)})
    return out


def phase_profile_sweep(device, model_path, data, top: int = 16) -> dict:
    """torch.profiler around a 3-step bf16 sweep of `SWEEP_CELLS`: of its
    last sweep step (the ``mmpfn.train.sweep_step`` span of `train/finetune_batch.py`,
    which ends in a device synchronize, so every kernel of the step runs
    inside it), the wall time, the device kernel time, the idle share and
    the kernels that took the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = sweep(device, model_path, data, SWEEP_CELLS, 3)
    events = prof.events()
    steps = [e for e in events if e.name == "mmpfn.train.sweep_step" and e.device_type == DeviceType.CPU]
    check(len(steps) == 3, f"the profile holds {len(steps)} mmpfn.train.sweep_step spans, expected 3")
    t0, t1 = steps[-1].time_range.start, steps[-1].time_range.end
    sums: dict[str, list] = {}
    for e in events:
        if (e.device_type == DeviceType.CUDA and not e.is_user_annotation
                and t0 <= e.time_range.start and e.time_range.end <= t1):
            row = sums.setdefault(e.name[:90], [0.0, 0])
            row[0] += (e.time_range.end - e.time_range.start) / 1e3
            row[1] += 1
    rows = sorted(((ms, n, name) for name, (ms, n) in sums.items()), reverse=True)
    n_runs = len(out["run_cells"])
    print_profile(f"one warm sweep step ({n_runs} runs, each a bf16 step and its validation, 12 layers)",
                  (t1 - t0) / 1e3, rows, top)
    busy = sum(r[0] for r in rows)
    return dict(wall_ms=(t1 - t0) / 1e3, kernel_ms=busy, per_run_kernel_ms=busy / n_runs)


def phase_profile_dinov2(device, vit_cfg, img_size: int, batch: int, top: int = 14) -> None:
    """torch.profiler around one warm ``embed_images`` call on a batch of
    ``batch`` images (the host-to-device copy of the pixels and the fetch of
    the embeddings inside it): wall time, device kernel time, the idle share
    and the kernels that took the most time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimodalpfn_tpu_torch.modal import dinov2

    params = dinov2.prepare_params(
        dinov2.init_vit_params(torch.Generator().manual_seed(0), vit_cfg), vit_cfg, device)
    imgs = np.random.default_rng(3).random((batch, 1, 3, img_size, img_size), dtype=np.float32)
    dinov2.embed_images(params, vit_cfg, imgs, batch_size=batch, device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dinov2.embed_images(params, vit_cfg, imgs, batch_size=batch, device=device)
        wall = (time.perf_counter() - t0) * 1e3
    print_profile(f"DINOv2 embed_images, a warm batch of {batch} images at {img_size} px", wall,
                  device_kernel_rows(prof), top)


def phase_profile_regressor(device, model_path, data, n: int, top: int = 14) -> None:
    """torch.profiler around one warm regressor request (fit_preprocessors,
    bf16): wall time, device kernel time, the idle share (the host finalize
    runs with the card idle) and the kernels that took the most time."""
    from torch.profiler import ProfilerActivity, profile

    X_tr, img_tr, y_tr, X_te, img_te = data
    reg = make_regressor(device, model_path)
    reg.fit(X_tr, img_tr, y_tr)
    reg.predict(X_te[:n], img_te[:n])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reg.predict(X_te[:n], img_te[:n], output_type="full")
        wall = (time.perf_counter() - t0) * 1e3
    print_profile(f"regressor request of {n} rows (output_type full)", wall, device_kernel_rows(prof), top)


# ---- phase 24: the entry points (the CLIs and the examples) -------------------------

# PAD-UFES-20's six diagnostics and the boolean answers of its metadata.csv
PAD_DIAGNOSTICS = ("ACK", "BCC", "MEL", "NEV", "SCC", "SEK")
PAD_BOOL_CATS = ("smoke", "drink", "pesticide", "skin_cancer_history", "cancer_history", "has_piped_water",
                 "has_sewage_system", "itch", "grew", "hurt", "bleed", "elevation", "biopsed", "changed")
CLI_STEPS = 20
# the reference's fine-tune length, which `run_experiment` (`evaluate_cell`)
# and the multimodal example run
REFERENCE_STEPS = 100
# the kernel names of the wgmma bodies of K1 (and K5, K6a, K6b), K2a's
# attention, K2b and K3, as the profiler's trace names them
WGMMA_TRACE_NAMES = ("feat_attn_wg_kernel", "fwd_wg_kernel", "epilogue_ln_wg_kernel", "mlp_ln_wg_kernel")
EXAMPLES = ("mmpfn_multimodal_classification", "serving_pipelined_requests", "tabpfn_for_binary_classification",
            "tabpfn_for_multiclass_classification", "tabpfn_for_regression")


def write_pad_ufes_dir(root: Path, image_emb, seed: int = 0) -> None:
    """A PAD-UFES-20-shaped data directory under ``root``: ``data/pad_ufes_20/
    metadata.csv`` of one row per embedding with the columns the loader
    reads and the six diagnostics in turn (as `tests/test_run_published.py`'s
    fixture builds its 120 rows), the image cache holding ``image_emb`` and
    the clinical-note cache holding seeded random (rows, 1, 768)
    embeddings."""
    import numpy as np
    import pandas as pd

    n = len(image_emb)
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({c: rng.integers(0, 2, n).astype(bool) for c in PAD_BOOL_CATS})
    df["background_father"] = rng.choice(["POMERANIA", "GERMANY"], n)
    df["background_mother"] = rng.choice(["POMERANIA", "ITALY"], n)
    df["gender"] = rng.choice(["MALE", "FEMALE"], n)
    df["region"] = rng.choice(["ARM", "FACE"], n)
    df["age"] = rng.integers(20, 80, n)
    df["diameter_1"] = rng.uniform(2, 12, n).round(1)
    df["diameter_2"] = rng.uniform(2, 12, n).round(1)
    df["diagnostic"] = np.array(PAD_DIAGNOSTICS)[np.arange(n) % len(PAD_DIAGNOSTICS)]
    df["img_id"] = [f"PAT_{i}.png" for i in range(n)]
    data = root / "data" / "pad_ufes_20"
    data.mkdir(parents=True)
    df.to_csv(data / "metadata.csv", index=False)
    cache = root / "embeddings" / "pad_ufes_20"
    cache.mkdir(parents=True)
    np.savez_compressed(cache / "pad_ufes_20_dinov2.npz", embeddings=np.asarray(image_emb, np.float32))
    np.savez_compressed(cache / "pad_ufes_20_clinical_electra.npz",
                        emb=rng.normal(size=(n, 1, 768)).astype(np.float32))


def tensors_of(obj) -> list:
    """Every tensor in a nested dict, list or tuple."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for item in obj for t in tensors_of(item)]
    return []


class DeviceWatch:
    """Records every estimator fitted (``MMPFNClassifier``, ``MMPFNRegressor``
    and their TabPFN subclasses) and every fine-tune's step loop
    (`train/finetune.make_episode_trainer`) while it is entered, and checks
    that each model, its parameters and the train split sit on the card."""

    def __enter__(self):
        from multimodalpfn_tpu_torch import MMPFNClassifier, MMPFNRegressor
        from multimodalpfn_tpu_torch.train import finetune

        self.estimators, self.trainers, self._undo = [], [], []

        def wrap(owner, name, record):
            orig = getattr(owner, name)

            def wrapped(*args, **kwargs):
                out = orig(*args, **kwargs)
                record(args[0] if isinstance(owner, type) else out)
                return out

            setattr(owner, name, wrapped)
            self._undo.append((owner, name, orig))

        for cls in (MMPFNClassifier, MMPFNRegressor):
            wrap(cls, "fit", self.estimators.append)
        wrap(finetune, "make_episode_trainer", self.trainers.append)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        return False

    def check(self, tag: str, device) -> str:
        if device.type != "cuda":
            return f"{len(self.estimators)} estimators, {len(self.trainers)} fine-tunes"
        for est in self.estimators:
            leaves = tensors_of(est.params_)
            check(est.device_.type == "cuda" and leaves and all(t.is_cuda for t in leaves),
                  f"{tag}: {type(est).__name__} holds parameters off the card")
        for tr in self.trainers:
            leaves = tensors_of(tr.state.params) + tensors_of(tr.data)
            check(leaves and all(t.is_cuda for t in leaves), f"{tag}: a fine-tune holds tensors off the card")
        return (f"{len(self.estimators)} estimators and {len(self.trainers)} fine-tunes, every parameter "
                f"and train split on the card")


def captured(fn) -> tuple[dict, str]:
    """``fn()`` with its standard output captured: what it returned and what
    it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def printed_json(printed: str):
    """The JSON object a CLI printed on its last line."""
    import json

    return json.loads(printed.strip().splitlines()[-1])


def check_entry_launches(tag: str, device, launches: dict, bodies: dict, finetune_steps: int = 0,
                         cached: bool = False, n_layers: int = 12) -> None:
    """The launch counters of one CLI or example run (zeroed just before):
    K7, K8, K9 and K10 exactly ``n_layers`` times each fine-tune step (as
    phase 9 reckons them), the forward kernels of the served mode, every
    K1, K5, K6a, K6b, K2b and K3 launch, K7's per-row attention, K8 and
    K10 on the wgmma body, and neither K7s nor K11 (only the flash fine-tune
    runs them)."""
    print(f"  {tag} launches { {k: v for k, v in launches.items() if v} }; by body "
          f"{ {k: v for k, v in bodies.items() if v} }", flush=True)
    if device.type != "cuda":
        return
    for kid in ("K7", "K8", "K9", "K10"):
        check(launches[kid] == n_layers * finetune_steps,
              f"{tag}: {kid} launched {launches[kid]} times, expected {n_layers} x {finetune_steps}")
    forward = ("K4", "K3") if cached else ("K2a", "K2b", "K3")
    for kid in forward:
        check(launches[kid] > 0, f"{tag}: {kid} was not launched")
    feat = ("K5", "K6b") if cached else ("K1", "K6a")
    check(sum(launches[k] for k in feat) > 0, f"{tag}: no feature-attention kernel ({', '.join(feat)}) launched")
    check(launches["K7s"] == 0 and launches["K11"] == 0, f"{tag}: the flash fine-tune's kernels launched")
    check_wgmma_bodies(tag, launches, bodies, ("K2b", "K3") + FEAT_IDS + ("K7", "K8", "K10"))


def phase_entry_points(device, model_path: Path, reg_path: Path, data, image_emb, root: Path,
                       steps: int, example_steps: int) -> dict:
    """The user's own commands on the card: `scripts/run_published.py`
    (configs 1-4, 1 seed, ``steps`` fine-tune steps), `scripts/run_experiment.py`
    (pad_ufes_20, one grid cell mgm 16 × cap 8 from a YAML written here, 1
    seed), `scripts/finetune_cli.py` (``steps`` steps on ``data`` saved as
    ``.npy``) and the five examples' ``main``, each inside the port's
    `PhaseTimer`, in ``root`` (a PAD-UFES-20-shaped directory whose image
    cache holds ``image_emb``), with the launch counters zeroed just before
    each and read just after. Gates: each CLI's printed JSON equals what it
    returned and the file it wrote; every estimator and fine-tune on the
    card (`DeviceWatch`); the launch counts (`check_entry_launches`);
    ``run_published``'s config-1 accuracy and AUROC equal, bit for bit, a
    direct ``TabPFNClassifier`` call with the same arguments; config 1 run
    again inside `utils/profiling.trace` gives the same answer and its trace
    names the wgmma kernels; the serving example's pipelined answers equal
    its sequential ones."""
    import importlib
    import json
    import os
    import shutil

    import numpy as np

    from multimodalpfn_tpu_torch import TabPFNClassifier
    from multimodalpfn_tpu_torch.datasets.loaders import PADUFES20Dataset
    from multimodalpfn_tpu_torch.hpo.experiment import nanmin_impute
    from multimodalpfn_tpu_torch.models.loading import load_model
    from multimodalpfn_tpu_torch.ops import kernels
    from multimodalpfn_tpu_torch.scripts import finetune_cli, run_experiment, run_published
    from multimodalpfn_tpu_torch.train.metrics import get_scorer
    from multimodalpfn_tpu_torch.utils import profiling

    shutil.rmtree(root, ignore_errors=True)
    write_pad_ufes_dir(root, image_emb)
    X, img, y = data
    for name, a in (("x", X), ("image", img), ("y", y)):
        np.save(root / f"{name}.npy", a)
    (root / "cell.yaml").write_text("# one grid cell\nmgm_heads_list: [16]\ncap_heads_list: [8]\n"
                                    "features_per_group: 1\nmixer_type: \"MGM+CAP\"\n")
    dev = str(device)
    timer = profiling.PhaseTimer(device=device)
    out: dict = {"launches": {}}

    def measured(tag: str, fn):
        kernels.reset_launches()
        with DeviceWatch() as watch, timer.phase(tag):
            result = fn()
        launches, bodies = dict(kernels.LAUNCHES), dict(kernels.BODY_LAUNCHES)
        print(f"  {tag}: {timer.totals[tag]:.2f} s; {watch.check(tag, device)}", flush=True)
        return result, launches, bodies

    cwd = os.getcwd()
    os.chdir(root)  # every relative path of the CLIs (logs/, checkpoints/, results/) lands under root
    try:
        published = ["--data-root", "data", "--embeddings-root", "embeddings", "--ckpt", str(model_path),
                     "--seeds", "1", "--steps", str(steps), "--device", dev]
        pub_argv = published + ["--configs", "1,2,3,4", "--results", "results/published_run.json"]
        (pub, printed), launches, bodies = measured("run_published", lambda: captured(
            lambda: run_published.main(pub_argv)))
        check(printed_json(printed) == pub
              == json.loads((root / "results" / "published_run.json").read_text()),
              "run_published: the printed JSON differs from the results file")
        for r in pub["runs"]:
            print(f"    {r['config']}: accuracy {r['accuracy_mean']:.4f}, AUROC {r['auroc_mean']:.4f}, "
                  f"{r['wall_s']} s", flush=True)
            check(0.0 <= r["accuracy_mean"] <= 1.0 and 0.0 <= r["auroc_mean"] <= 1.0,
                  f"run_published {r['config']}: metrics out of range")
        check([r["config"] for r in pub["runs"]] == ["1-tabular-only", "2-tabular+image", "3-tabular+text",
                                                     "4-trimodal-8member"], "run_published: configs missing")
        check_entry_launches("run_published", device, launches, bodies, finetune_steps=3 * steps)
        out["launches"]["cli_published"] = launches

        # config 1 by hand: the script's split, imputation and classifier
        ds = PADUFES20Dataset("data/pad_ufes_20", embeddings_root="embeddings", device=dev)
        Xp, yp = np.asarray(ds.x, dtype=float), np.asarray(ds.y)
        perm = np.random.default_rng(0).permutation(len(yp))
        tr, te = perm[: int(len(yp) * 0.8)], perm[int(len(yp) * 0.8):]
        clf = TabPFNClassifier(model_path=str(model_path), ignore_pretraining_limits=True, n_estimators=4,
                               categorical_features_indices=list(range(len(ds.cat_features))), random_state=0,
                               device=dev)
        proba = clf.fit(nanmin_impute(Xp[tr]), yp[tr]).predict_proba(nanmin_impute(Xp[te]))
        acc = float(np.mean(clf.classes_[np.argmax(proba, axis=1)] == yp[te]))
        auc = float(get_scorer("roc_auc")(yp[te], proba))
        first = pub["runs"][0]
        print(f"  direct TabPFNClassifier: accuracy {acc!r}, AUROC {auc!r}; run_published config 1: "
              f"{first['accuracy_mean']!r}, {first['auroc_mean']!r}", flush=True)
        check(acc == first["accuracy_mean"] and auc == first["auroc_mean"],
              "run_published config 1 differs from the direct TabPFNClassifier call")

        trace_dir = root / "trace"
        with profiling.trace(str(trace_dir)):
            traced, _ = captured(lambda: run_published.main(published + ["--configs", "1", "--results",
                                                                           "results/traced.json"]))
        events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
        names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
        found = {k: sum(k in nm for nm in names) for k in WGMMA_TRACE_NAMES}
        same = all(traced["runs"][0][k] == first[k] for k in ("accuracy_mean", "auroc_mean"))
        print(f"  config 1 inside profiling.trace ({trace_dir.name}/trace.json): {len(events)} events, "
              f"{len(names)} kernel names, the wgmma bodies' names {found}; the same answer: {same}", flush=True)
        check(same, "the traced config 1 answers differently")
        if device.type == "cuda":
            check(all(found.values()), f"the trace does not name every wgmma kernel: {found}")

        exp_argv = ["pad_ufes_20", "--data-root", "data", "--config", "cell.yaml", "--base-model", str(model_path),
                    "--seeds", "1", "--results-dir", "results", "--device", dev]
        (best, printed), launches, bodies = measured("run_experiment",
                                                     lambda: captured(lambda: run_experiment.main(exp_argv)))
        study = json.loads((root / "results" / "pad_ufes_20.json").read_text())
        (trial,) = study["trials"]
        print(f"    trial {trial['params']}: {trial['state']}, accuracy {trial['value']}", flush=True)
        check(printed_json(printed) == best
              == {"best_params": trial["params"], "best_value": trial["value"]},
              "run_experiment: the printed JSON differs from the study file")
        check(trial["state"] == "complete" and trial["user_attrs"]["n_completed_seeds"] == 1,
              f"run_experiment: the cell is {trial['state']}")
        check_entry_launches("run_experiment", device, launches, bodies, finetune_steps=REFERENCE_STEPS)
        out["launches"]["cli_experiment"] = launches

        ft_argv = ["--x", "x.npy", "--image", "image.npy", "--y", "y.npy", "--out", "checkpoints/finetune_cli.ckpt",
                   "--base", str(model_path), "--mgm-heads", "16", "--cap-heads", "8", "--fpg", "1",
                   "--steps", str(steps), "--device", dev]
        (ft, printed), launches, bodies = measured("finetune_cli", lambda: captured(lambda: finetune_cli.main(ft_argv)))
        snap = load_model(root / ft["out"], mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8)
        print(f"    {ft}; the checkpoint loads ({len(tensors_of(snap.params))} leaves)", flush=True)
        check(printed_json(printed) == ft and ft["steps"] == steps
              and np.isfinite(ft["best_val_error"]), f"finetune_cli printed {printed!r}")
        check_entry_launches("finetune_cli", device, launches, bodies, finetune_steps=steps)
        out["launches"]["cli_finetune"] = launches

        total: dict = {}
        for name in EXAMPLES:
            mod = importlib.import_module(f"multimodalpfn_tpu_torch.examples.{name}")
            path = reg_path if name.endswith("regression") else model_path
            # phase 1's model has one feature per group
            kw = {"max_steps": example_steps, "features_per_group": 1} if name.startswith("mmpfn") else {}
            (res, _), launches, bodies = measured(name, lambda: captured(lambda: mod.main(str(path), dev, **kw)))
            shown = {k: v for k, v in res.items() if k not in ("probas", "sequential")}
            print(f"    {shown}", flush=True)
            check(all(np.isfinite(v).all() for v in shown.values() if not isinstance(v, bool)),
                  f"{name}: non-finite metrics {shown}")
            if name.startswith("serving"):
                check(res["pipelined_equals_sequential"], "serving example: pipelined differs from sequential")
            check_entry_launches(name, device, launches, bodies,
                                 finetune_steps=example_steps if name.startswith("mmpfn") else 0,
                                 cached=name.startswith("serving"))
            total = {k: total.get(k, 0) + v for k, v in launches.items()}
        out["launches"]["examples"] = total
    finally:
        os.chdir(cwd)
    out["report"] = timer.report()
    print(f"  PhaseTimer report: {json.dumps(out['report'])}", flush=True)
    print(f"  live_device_memory(): {profiling.live_device_memory()}", flush=True)
    return out


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
    launches = check_served_launches(device, fit_mode, plans, len(request_sizes), n_layers)
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


def check_served_launches(device, fit_mode, plans, n_requests, n_layers) -> dict:
    """The launch counters after the served requests (zeroed just before
    them; fit_with_cache: before the fit, whose prime launches kernels too):
    every layer of every planned group ran the mode's kernels in each pass,
    the other mode's kernels never ran, and, in bf16 at e = 192 (d = 32,
    nhid = 768), every K2b, K3, K1, K5, K6a and K6b launch took its wgmma
    body. Returns the counts."""
    from multimodalpfn_tpu_torch.ops import kernels

    launches = dict(kernels.LAUNCHES)
    bodies = dict(kernels.BODY_LAUNCHES)
    cached = fit_mode == "fit_with_cache"
    groups, merged = len(plans), sum(m for _, _, m in plans)
    passes = n_requests + 1 if cached else n_requests
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
        check_wgmma_bodies(fit_mode, launches, bodies)
    return launches


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


# phase 25: the mesh and the ring (`parallel/`). 25a runs the ring over every
# card on NCCL at the flash fine-tune's train block (G = 30 x 6 = 180, S =
# 1654, d = 32); 25b runs four ranks that share the card over gloo as a
# (2, 2) mesh: a ring of 2 over dp, tensor parallelism of 2 over mp
RING_DIMS = (30, 6, 1654, 32)
RING_ITERS = 10
MESH_RANKS = 4
# (train, test) rows: the flagship split for the forward; the fine-tune
# episode cut to an even train-row count for the steps (its 1655 is odd and
# the ring needs the train rows to divide over its 2 ranks)
RING_FWD_ROWS, RING_STEP_ROWS = (1838, 460), (1654, 184)
# the ring against the unsharded path in float32, relative to the largest
# logit (the forward) or to each leaf's largest gradient (the step)
RING_REL_BOUND = 1e-4
# one dp x mp step against the single-process step on the whole batch: the dp
# mean adds the two episodes' gradients in another order than the batched
# backward, so the two agree to rounding, not bit for bit, as the ring step
# does: loss, gradient norm and every gradient (relative to its leaf's
# largest) within the ring's bound, the params after the step within
# FT_PARAM_ABS_BOUND absolute (Adam divides a near-zero gradient by its own
# size, so a param's update, at most the learning rate, is not relative to
# the leaf)
MESH_STEP_REL_BOUND = RING_REL_BOUND
MESH_SWEEP_STEPS = 3


def max_rel(got, want) -> float:
    """Largest difference relative to ``want``'s largest magnitude."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def sweep_digest(out: dict) -> dict:
    """A sweep's history and a digest of every final param: equal exactly
    when the two sweeps are."""
    from multimodalpfn_tpu_torch.models.params import flatten_params

    h = out["history"]
    return {"train_loss": h["train_loss"], "val_error": h["val_error"], "skipped": h["skipped_steps"],
            "params": {k: digest(v) for k, v in flatten_params(out["params_stacked"]).items()}}


def ring_kernel_rank(rank: int, world: int, dims, iters: int) -> dict:
    """Phase 25a on one rank (a card a rank over NCCL; a rehearsal: the CPU
    over gloo). `ring_attention` with ``use_flash``, forward and backward, on
    q, k, v (b·t, h, S, d) in float32 and bf16, held to K4 and K11 on the
    whole K/V (`F32_REL_BOUND`, `BF16_REL_BOUND` of each output's largest);
    on the card K4 and K11 launch once a ring step; the ring's forward and
    backward timed against the whole K/V's (CUDA events)."""
    import torch
    import torch.distributed as dist

    from multimodalpfn_tpu_torch.ops import kernels
    from multimodalpfn_tpu_torch.ops.flash import flash_attention, flash_attention_bwd
    from multimodalpfn_tpu_torch.parallel.mesh import make_mesh
    from multimodalpfn_tpu_torch.parallel.ring_attention import ring_attention

    on_card = dist.get_backend() == "nccl"
    device = torch.device("cuda" if on_card else "cpu")
    mesh = make_mesh()
    B, h, S, d = dims
    gen = torch.Generator().manual_seed(0)
    out: dict = {"ranks": world}
    for dtype, rel_bound in ((torch.float32, F32_REL_BOUND), (torch.bfloat16, BF16_REL_BOUND)):
        tag = "f32" if dtype == torch.float32 else "bf16"
        q, k, v, g = (torch.randn((B, h, S, d), generator=gen).to(device) for _ in range(4))
        q, k, v = (t.to(dtype).requires_grad_(True) for t in (q, k, v))

        def ring_step():
            for t in (q, k, v):
                t.grad = None
            o = ring_attention(q, k, v, mesh=mesh, use_flash=True)
            o.backward(g)
            return o

        kernels.reset_launches()
        o = ring_step()
        launches = {kid: kernels.LAUNCHES[kid] for kid in ("K4", "K11")}
        got = [o.detach(), q.grad, k.grad, v.grad]
        q3, k3, v3, g3 = (t.detach().reshape(B * h, S, d).contiguous() for t in (q, k, v, g))

        @torch.no_grad()
        def whole_step():
            o_w, lse_w = flash_attention(q3, k3, v3)
            return [o_w, *flash_attention_bwd(q3, k3, v3, o_w, lse_w, g3)]

        errs = [max_rel(a.reshape(w.shape), w) for a, w in zip(got, whole_step())]
        check(max(errs) <= rel_bound, f"25a {tag}: the ring differs from K4 and K11 on the whole K/V by "
                                      f"{errs} (bound {rel_bound})")
        if on_card:
            check(launches == {"K4": world, "K11": world},
                  f"25a {tag}: launches {launches}, expected one K4 and one K11 a ring step ({world})")
        ring_step()  # `timed` warms with one call; the allocator settles after a few
        whole_step()
        out[tag] = {"errs": errs, "launches": launches, "ring_ms": timed(ring_step, device, iters),
                    "whole_ms": timed(whole_step, device, iters)}
    return out


def ring_batch(X, img, y, rows, device, order=None) -> dict:
    """One episode (b = 1): ``rows`` = (train, test) rows of ``order`` (the
    data's own order by default), float32 on ``device``."""
    import numpy as np
    import torch

    n_tr, n_te = rows
    idx = np.arange(n_tr + n_te) if order is None else np.asarray(order)[: n_tr + n_te]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)[idx][None], device=device)

    x, im, yy = t(X), t(img), t(y)
    return {"x_train": x[:, :n_tr], "x_test": x[:, n_tr:], "image_train": im[:, :n_tr],
            "image_test": im[:, n_tr:], "y_train": yy[:, :n_tr], "y_test": yy[:, n_tr:]}


def mesh_step_batch(X, img, y, rows, device) -> dict:
    """Two episodes: the data's first rows and a seeded permutation of them."""
    import numpy as np
    import torch

    n = sum(rows)
    a = ring_batch(X, img, y, rows, device)
    b = ring_batch(X, img, y, rows, device, order=np.random.default_rng(1).permutation(n))
    return {k: torch.cat([a[k], b[k]]) for k in a}


def mesh_model(model_path, device):
    """The served model in float32 with the kernels on and the fused item
    sublayer off (K4 serves the item attention, as under a ring axis)."""
    import dataclasses

    from multimodalpfn_tpu_torch.models.loading import load_npz

    loaded = load_npz(model_path, device)
    return loaded.params, dataclasses.replace(loaded.config, compute_dtype="float32", use_flash=True,
                                              fused_ops=True, fused_item=False)


def mesh_step(params, cfg, batch, mesh=None) -> tuple:
    """One schedule-free step at lr 1e-5 (``mesh``: the params sharded over
    its mp axis and the batch's episodes over dp); returns the state and the
    step's metrics."""
    from multimodalpfn_tpu_torch.parallel.mesh import shard_params
    from multimodalpfn_tpu_torch.train.losses import get_loss_fn
    from multimodalpfn_tpu_torch.train.step import init_train_state, make_optimizer, make_train_step

    if mesh is not None:
        params = shard_params(params, mesh)
    state = init_train_state(params, lambda p: make_optimizer(p, 1e-5))
    return make_train_step(cfg, get_loss_fn("multiclass"), mesh)(state, batch, None)


def mesh_step_reference(device, model_path, data, rows, path: Path) -> dict:
    """The single-process step on `mesh_step_batch`'s two episodes; every
    gradient and every param after the step are written to ``path`` for the
    ranks to compare with."""
    import torch

    from multimodalpfn_tpu_torch.models.params import flatten_params

    params, cfg = mesh_model(model_path, device)
    state, m = mesh_step(params, cfg, mesh_step_batch(*data, rows, device))
    flat = flatten_params(state.params)
    ref = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "applied": m["applied"],
           "grads": {k: p.grad.detach().cpu() for k, p in flat.items()},
           "params": {k: p.detach().cpu() for k, p in flat.items()}}
    torch.save(ref, path)
    return {k: ref[k] for k in ("loss", "grad_norm", "applied")}


def mesh_rank(rank: int, world: int, device: str, model_path: str, data, served, sizes, answers,
              sweep_data, fwd_rows, step_rows, ref_path: str) -> dict:
    """Phase 25b on one rank of the (2, 2) mesh (gloo; the card shared, or
    the CPU in a rehearsal): the ring forward and training step against the
    unsharded ones, the sweep over dp, the classifier served from mp shards
    and one dp x mp step (module constants for the bounds)."""
    import dataclasses

    import torch

    from multimodalpfn_tpu_torch.models.params import flatten_params
    from multimodalpfn_tpu_torch.models.transformer import forward
    from multimodalpfn_tpu_torch.ops import kernels
    from multimodalpfn_tpu_torch.parallel.mesh import (
        axis_size, full_grad, gather_tree, make_mesh, set_mesh, shard_axis, shard_estimator)

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def sync():
        if on_card:
            torch.cuda.synchronize()

    mesh = make_mesh(mp=2)
    n = axis_size(mesh, "dp")
    X, img, y = data
    params, cfg = mesh_model(model_path, device)
    ring_cfg = dataclasses.replace(cfg, seq_shard_axis="dp")
    L = cfg.nlayers
    out: dict = {"layers": L, "seconds": {}}
    t_part = time.perf_counter()

    def part(name: str) -> None:
        nonlocal t_part
        now = time.perf_counter()
        out["seconds"][name] = round(now - t_part, 2)
        t_part = now

    # the forward on the flagship split, with and without the ring
    b = ring_batch(X, img, y, fwd_rows, device)
    x, im = torch.cat([b["x_train"], b["x_test"]], 1), torch.cat([b["image_train"], b["image_test"]], 1)
    with set_mesh(mesh):
        kernels.reset_launches()
        got = forward(params, ring_cfg, x, b["y_train"], im, single_eval_pos=fwd_rows[0])
        sync()
        fwd_launches = dict(kernels.LAUNCHES)
    want = forward(params, cfg, x, b["y_train"], im, single_eval_pos=fwd_rows[0])
    out["fwd_rel"] = max_rel(got, want)
    check(out["fwd_rel"] <= RING_REL_BOUND, f"25b: the ring forward differs by {out['fwd_rel']:.3e}")

    # one training step at the cut episode, with and without the ring
    batch = ring_batch(X, img, y, step_rows, device)
    with set_mesh(mesh):
        kernels.reset_launches()
        s_ring, m_ring = mesh_step(params, ring_cfg, batch)
        sync()
        step_launches = dict(kernels.LAUNCHES)
    s_plain, m_plain = mesh_step(params, cfg, batch)
    out["loss_rel"] = abs(float(m_ring["loss"]) - float(m_plain["loss"])) / abs(float(m_plain["loss"]))
    pairs = zip(flatten_params(s_ring.params).items(), flatten_params(s_plain.params).values())
    out["grad_rel"] = max(max_rel(p.grad, q.grad) for (_, p), q in pairs)
    check(out["loss_rel"] <= RING_REL_BOUND and out["grad_rel"] <= RING_REL_BOUND,
          f"25b: the ring step's loss differs by {out['loss_rel']:.3e}, a gradient by {out['grad_rel']:.3e}")
    if on_card:
        expect = {"K4": 2 * L * n, "K11": 2 * L * n, "K1": L, "K3": L, "K7": L, "K8": L, "K2a": 0, "K9": 0}
        for tag, launches, kids in (("forward", fwd_launches, ("K4", "K1", "K3", "K2a")),
                                    ("step", step_launches, tuple(expect))):
            for kid in kids:
                check(launches[kid] == expect[kid],
                      f"25b ring {tag}: {kid} launched {launches[kid]} times, expected {expect[kid]}")
    times = {}  # one more step of each, the checked ones having warmed them
    for tag, c in (("ring", ring_cfg), ("unsharded", cfg)):
        with set_mesh(mesh):
            sync()
            t0 = time.perf_counter()
            mesh_step(params, c, batch)
            sync()
        times[tag] = (time.perf_counter() - t0) * 1e3
    out.update(fwd_launches=fwd_launches, step_launches=step_launches, step_ms=times)
    part("ring")

    # the sweep, its runs over dp
    out["sweep"] = sweep_digest(sweep(device, model_path, sweep_data, SWEEP_CELLS, MESH_SWEEP_STEPS, mesh=mesh))
    part("sweep")

    # the classifier served from mp shards
    X_tr, img_tr, y_tr, X_te, img_te = served
    clf = make_classifier(device, model_path).fit(X_tr, img_tr, y_tr)
    shard_estimator(clf, mesh)
    check(any(shard_axis(v) is not None for v in flatten_params(clf.params_).values()),
          "25b: shard_estimator sharded nothing")
    with set_mesh(mesh):
        got = [clf.predict_proba(X_te[:k], img_te[:k]) for k in sizes]
    out["served_equal"] = all(a.shape == w.shape and bool((a == w).all()) for a, w in zip(got, answers))
    check(out["served_equal"], "25b: the classifier served from mp shards differs from phase 3's answers")
    part("served")

    # one dp x mp step against the single-process step on the whole batch
    state, m = mesh_step(params, cfg, mesh_step_batch(X, img, y, step_rows, device), mesh)
    ref = torch.load(ref_path)
    with set_mesh(mesh), torch.no_grad():
        flat = flatten_params(state.params)
        grads = {k: full_grad(p) for k, p in flat.items()}
        after = flatten_params(gather_tree(state.params))
    out["dpmp"] = {"loss_rel": abs(float(m["loss"]) - ref["loss"]) / abs(ref["loss"]),
                   "grad_norm_rel": abs(float(m["grad_norm"]) - ref["grad_norm"]) / ref["grad_norm"],
                   "grad_rel": max(max_rel(grads[k], ref["grads"][k]) for k in grads),
                   "param_abs": max(float((after[k].detach().cpu() - ref["params"][k]).abs().max()) for k in after),
                   "applied": m["applied"]}
    d = out["dpmp"]
    check(d["applied"] and max(d["loss_rel"], d["grad_norm_rel"], d["grad_rel"]) <= MESH_STEP_REL_BOUND
          and d["param_abs"] <= FT_PARAM_ABS_BOUND, f"25b: the dp x mp step differs: {d}")
    part("dp_mp_step")
    return out


def phase_mesh(device, model_path, data, served, sizes, answers, sweep_data, rehearse: bool) -> dict:
    """Phase 25: 25a (`ring_kernel_rank`) on every card over NCCL, then 25b
    (`mesh_rank`) on `MESH_RANKS` ranks that share the card over gloo, after
    the single-process references (the sweep, the dp x mp step) here."""
    import shutil

    import torch

    from multimodalpfn_tpu_torch.parallel.launch import run_ranks

    work = ROOT / "build" / "phase25"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # on the CPU the references take the ranks' thread count: the same sums
    # in the same order
    threads, main_threads = (2 if rehearse else None), torch.get_num_threads()
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        n_cards = torch.cuda.device_count() if device.type == "cuda" else 1
        dims = (2, 3, 40, 8) if rehearse else RING_DIMS
        a = run_ranks(ring_kernel_rank, n_cards, dims, 2 if rehearse else RING_ITERS, workdir=work / "a",
                      device=device.type, threads=None, timeout=600)[0]
        for tag in ("f32", "bf16"):
            r = a[tag]
            print(f"  25a {tag}: a ring of {a['ranks']} over {'NCCL' if device.type == 'cuda' else 'gloo'} at (G, S, d) = ({dims[0] * dims[1]}, "
                  f"{dims[2]}, {dims[3]}): o, dq, dk, dv against K4 and K11 on the whole K/V "
                  f"{[f'{e:.2e}' for e in r['errs']]}; launches {r['launches']} (one K4 and one K11 a ring "
                  f"step); forward + backward {r['ring_ms']:.3f} ms against {r['whole_ms']:.3f} ms whole",
                  flush=True)
        fwd_rows, step_rows = ((120, 30), (100, 20)) if rehearse else (RING_FWD_ROWS, RING_STEP_ROWS)
        want_sweep = sweep_digest(sweep(device, model_path, sweep_data, SWEEP_CELLS, MESH_SWEEP_STEPS))
        ref = mesh_step_reference(device, model_path, data, step_rows, work / "ref_step.pt")
        t0 = time.perf_counter()
        outs = run_ranks(mesh_rank, MESH_RANKS, str(device), str(model_path), data, served, sizes, answers,
                         sweep_data, fwd_rows, step_rows, str(work / "ref_step.pt"), workdir=work / "b",
                         device="cpu", threads=threads, timeout=900)
        wall = time.perf_counter() - t0
    finally:
        torch.set_num_threads(main_threads)
        shutil.rmtree(work, ignore_errors=True)
    for r, o in enumerate(outs):
        check(o["sweep"] == want_sweep, f"25b rank {r}: the sweep over dp differs from the single-process sweep")
    b = outs[0]
    n_ring = MESH_RANKS // 2
    print(f"  25b: {MESH_RANKS} ranks over gloo sharing the card, a (2, 2) mesh, in {wall:.1f} s: the ring "
          f"forward ({fwd_rows[0]} + {fwd_rows[1]} rows) against the unsharded one {b['fwd_rel']:.2e}; the "
          f"ring step ({step_rows[0]} + {step_rows[1]} rows) loss {b['loss_rel']:.2e}, gradients "
          f"{b['grad_rel']:.2e} (bound {RING_REL_BOUND}); the sweep over dp ({len(SWEEP_CELLS) * 2} runs, "
          f"{MESH_SWEEP_STEPS} steps) equal to the single-process sweep on every rank; the classifier "
          f"served from mp shards equal to phase 3's answers; the dp x mp step against the single-process "
          f"step (loss {ref['loss']:.6f}): {b['dpmp']}; seconds by part (rank 0) {b['seconds']}", flush=True)
    print(f"  ring of {n_ring}: K4 and K11 launch once a ring step and block (2 blocks a layer, {b['layers']} "
          f"layers): forward {b['fwd_launches']['K4']} K4; training step {b['step_launches']['K4']} K4, "
          f"{b['step_launches']['K11']} K11; float32 step (host clock, rank 0) ring {b['step_ms']['ring']:.1f} "
          f"ms against unsharded {b['step_ms']['unsharded']:.1f} ms", flush=True)
    return {"a": a, "b": b}


def kernel_rows(kres: dict, launches: dict) -> list[dict]:
    """The ``kernels`` line: per kernel its bf16 numbers at the first shape
    (``ms`` etc.), every other measurement under its own key."""
    rows = []
    for kid, meta in KERNELS.items():
        r = dict(kres[kid])
        for sub in ("t48", "prime", "predict", "ft", "test", "folded", "ft_train", "ft_test",
                    "ft_folded", "dinov2", *K8_CASES, *K10_CASES):
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
        if kid in ("K4", "K11"):
            # phase 25: the ring's forward and training step (25b, rank 0),
            # and its forward + backward on NCCL (25a, bf16)
            row["launches_ring_forward"] = launches["ring_forward"][kid]
            row["launches_ring_step"] = launches["ring_step"][kid]
            row["launches_ring_nccl"] = launches["ring_nccl"][kid]
        for path in ("regressor", "regressor_cached", "regressor_finetune", "regressor_targets",
                     "regressor_targets_cached", "sweep", "sweep_padded_mgm",
                     "study_cross_cell", "study_sequential", "dinov2", "cli_published", "cli_experiment",
                     "cli_finetune", "examples"):
            row[f"launches_{path}"] = launches[path][kid]
        row.update({k: v for k, v in r.items() if k not in main.values()})
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase at a tiny size on the CPU; exits 1")
    ap.add_argument("--profile", action="store_true",
                    help="add phase 14, run last: profile one warm request of each size, a training "
                         "step of each item path, a warm regressor request and a warm sweep step")
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
        print(f"  (HGMMA, local loads and stores) in the SASS of K3's wgmma body (mlp_ln.cu) and K8's "
              f"row pass (mlp_ln_bwd.cu), by width: {k3_sass}", flush=True)
        check(set(k3_sass) == {f"{kid} e={w}" for kid in ("K3", "K8") for w in (64, 128, 192)}
              and all(h > 0 and spills == 0 for h, spills in k3_sass.values()),
              "K3's wgmma body or K8's row pass does not issue wgmma without spilling at every width")
        serial = serialized_wgmma(kernels.build_log(), "mlp_ln_bwd_wg_kernel")
        print(f"  ptxas serialization warnings (C75xx) for K8's row pass: {len(serial)}", flush=True)
        check(not serial, "ptxas serialized K8's row pass: " + "; ".join(serial[:2]))
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
        print(f"  (HGMMA, local loads and stores) in the SASS of K2b's wgmma body (item_epilogue.cu) "
              f"and K10's row pass (item_epilogue_bwd.cu), by width: {k2b_sass}", flush=True)
        check(set(k2b_sass) == {f"{kid} e={w}" for kid in ("K2b", "K10") for w in (64, 128, 192)}
              and all(h > 0 and spills == 0 for h, spills in k2b_sass.values()),
              "K2b's wgmma body or K10's row pass does not issue wgmma without spilling at every width")
        serial = serialized_wgmma(kernels.build_log(), "epilogue_ln_wg_kernel")
        print(f"  ptxas serialization warnings (C75xx) for K2b's wgmma body: {len(serial)}", flush=True)
        check(not serial, "ptxas serialized K2b's wgmma body: " + "; ".join(serial[:2]))
        serial = serialized_wgmma(kernels.build_log(), "epilogue_ln_bwd_wg_kernel")
        print(f"  ptxas serialization warnings (C75xx) for K10's row pass: {len(serial)}; its report: "
              f"{ptxas_usage(kernels.build_log(), 'epilogue_ln_bwd_wg_kernel')}", flush=True)
        check(not serial, "ptxas serialized K10's row pass: " + "; ".join(serial[:2]))
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
    reg_path = ROOT / "build" / "chip_smoke_regressor.npz"
    write_regression_model(reg_path)

    print("== phase 2: kernels against their plain versions", flush=True)
    if args.rehearse:
        dims, iters = (2, 7, 40, 30, 32, 4, 8, 64, 16), 1
    else:
        dims, iters = (4, 31, 2350, 1838, 192, 6, 32, 768, 512), 10
    ft_dims = (1, 5, 37, 21, 32, 4, 8, 64) if args.rehearse else FT_DIMS
    kres = phase_kernels(device, dims, iters, ft_dims, (8, 17, 64) if args.rehearse else VIT_ATTN_DIMS)

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

    y_reg = regression_target(X, y)
    reg_data = (X[:n_tr], img[:n_tr], y_reg[:n_tr], X[n_tr:], img[n_tr:])
    print("== phase 15: MMPFNRegressor, fit_preprocessors, served", flush=True)
    rpre = phase_regressor_served(device, reg_path, reg_data, sizes, 12, "fit_preprocessors")
    print("== phase 16: regressor kernel path against plain path (float32)", flush=True)
    rcmp = phase_regressor_kernel_vs_plain(device, reg_path, reg_data)
    print("== phase 17: MMPFNRegressor, fit_with_cache, served", flush=True)
    rkv = phase_regressor_served(device, reg_path, reg_data, sizes, 12, "fit_with_cache")
    reg_steps = 2 if args.rehearse else REG_FT_STEPS
    print(f"== phase 18: fine_tune_mmpfn(task_type=\"regression\"), {reg_steps} bf16 steps, the "
          "snapshot served, then kernel path against plain path (float32)", flush=True)
    rft = phase_finetune(device, reg_path, (X, img, y_reg), reg_steps, ft_layers,
                         ROOT / "build" / "chip_smoke_regressor_finetuned.ckpt", task="regression")
    rft_cmp = phase_finetune_kernel_vs_plain(device, reg_path, (X, img, y_reg), cmp_layers,
                                             task="regression")
    print(f"== phase 26: MMPFNRegressor with the target transforms {', '.join(REG_TARGET_NAMES)}: "
          f"served in fit_preprocessors, {' and '.join(REG_TARGET_CACHED)} also in fit_with_cache and as "
          "float32 kernel path against plain path", flush=True)
    rtt = phase_regressor_targets(device, reg_path, reg_data, 12)

    sweep_steps = 2 if args.rehearse else SWEEP_STEPS
    sweep_data = (X[:300], img[:300], y[:300]) if args.rehearse else ft_data
    print(f"== phase 19: the sweep (fine_tune_batched_cells), {len(SWEEP_CELLS)} cells x 2 seeds, "
          f"{sweep_steps} bf16 steps, then the mgm-16 runs served", flush=True)
    sw = phase_sweep(device, model_path, sweep_data, sweep_steps, ft_layers, ROOT / "build")
    print("== phase 20: the sweep's float32 gates: kernel path against plain path, padded against "
          "unpadded, a padded MGM group", flush=True)
    sw32 = phase_sweep_f32(device, model_path, sweep_data, cmp_layers)
    print(f"== phase 21: the grid study (run_experiment_cross_cell, run_experiment)", flush=True)
    study = phase_study(device, model_path, sweep_data, 1 if args.rehearse else STUDY_STEPS, ROOT / "build")

    from multimodalpfn_tpu_torch.modal.dinov2 import ViTConfig
    from multimodalpfn_tpu_torch.modal.electra import ElectraConfig

    if args.rehearse:  # the full width at one block and 28 px; a narrow ELECTRA
        vit_cfg, vit_img = ViTConfig(depth=1), 28
        e_cfg, e_dims = ElectraConfig(vocab_size=100, hidden=64, layers=2, heads=4, intermediate=128,
                                      max_position=48), (8, 48, 32)
    else:
        vit_cfg, vit_img, e_cfg, e_dims = ViTConfig(), VIT_IMG, ElectraConfig(), (
            ELECTRA_SEQS, ELECTRA_LEN, ELECTRA_SHORT)
    print(f"== phase 22: DINOv2 ViT-B/14 ({vit_cfg.depth} blocks, {vit_cfg.compute_dtype}) embeds "
          f"{len(X)} images at {vit_img} px, then the classifier serves them", flush=True)
    vit = phase_dinov2(device, model_path, ft_data, vit_cfg, vit_img, VIT_BATCH, n_tr)
    print("== phase 23: the encoders' gates: DINOv2 kernel path against plain path, ELECTRA-base "
          "padding and batch invariance", flush=True)
    enc = phase_encoder_gates(device, vit_cfg, vit_img, VIT_BATCH, e_cfg, *e_dims)

    cli_steps, example_steps = (2, 2) if args.rehearse else (CLI_STEPS, REFERENCE_STEPS)
    print(f"== phase 24: the entry points: run_published (configs 1-4, {cli_steps} steps), run_experiment "
          f"(one cell), finetune_cli ({cli_steps} steps) and the five examples", flush=True)
    entry = phase_entry_points(device, model_path, reg_path, ft_data, vit["emb"], ROOT / "build" / "cli",
                               cli_steps, example_steps)

    print(f"== phase 25: the mesh and the ring (parallel/): 25a the ring over every card on NCCL, 25b "
          f"{MESH_RANKS} ranks sharing the card over gloo", flush=True)
    mesh = phase_mesh(device, model_path, ft_data, data, sizes, pre["answers"], sweep_data, args.rehearse)

    if args.profile:
        print("== phase 14: profile of warm requests and of a warm training step of each item "
              "path, and of a warm regressor request", flush=True)
        phase_profile(device, model_path, data, sizes)
        phase_profile_step(device, model_path, ft_data, ft_layers)
        phase_profile_step(device, nmq_path, ft_data, ft_layers, label=" of the flash path")
        phase_profile_regressor(device, reg_path, reg_data, sizes[0])
        phase_profile_sweep(device, model_path, sweep_data)
        phase_profile_dinov2(device, vit_cfg, vit_img, VIT_BATCH)

    rows = kernel_rows(kres, {"preproc": pre["launches"], "cached": kv["launches"],
                              "finetune": ft["launches"], "flash_finetune": fl["launches"],
                              "regressor": rpre["launches"], "regressor_cached": rkv["launches"],
                              "regressor_finetune": rft["launches"],
                              "regressor_targets": rtt["launches"],
                              "regressor_targets_cached": rtt["launches_cached"], "sweep": sw["launches"],
                              "sweep_padded_mgm": sw32["c"]["launches"],
                              "study_cross_cell": study["cross_cell"]["launches"],
                              "study_sequential": study["sequential"]["launches"],
                              "dinov2": vit["launches"], "ring_forward": mesh["b"]["fwd_launches"],
                              "ring_step": mesh["b"]["step_launches"],
                              "ring_nccl": mesh["a"]["bf16"]["launches"]} | entry["launches"]
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
          f"resumed at step {res['resumed_from']}; regressor: fit_preprocessors fit "
          f"{rpre['fit_ms']:.1f} ms, warm requests ms {rpre['warm']} (host finalize "
          f"{rpre['warm_host']}), fit_with_cache fit {rkv['fit_ms']:.1f} ms, warm {rkv['warm']} "
          f"(host finalize {rkv['warm_host']}), f32 probabilities err {rcmp['prob_err']:.3e}; "
          f"regression fine-tune {rft['hist']['steps']} steps, warm step {rft['warm_step_ms']:.1f} ms, "
          f"f32 kernel vs plain grads {rft_cmp['grad_rel']:.2e}; target transforms: host finalize ms "
          f"{ {k: round(v, 1) for k, v in rtt['warm_host'].items()} }, f32 probabilities err "
          f"{ {k: round(v['prob_err'], 9) for k, v in rtt['f32'].items()} }; sweep of {len(sw['hist']['best_val_error'])} "
          f"runs: warm sweep step {sw['warm_step_ms']:.1f} ms ({sw['per_run_ms']:.1f} ms per run), f32 "
          f"kernel vs plain loss {sw32['a']['loss_rel']:.2e} params {sw32['a']['param_err']:.2e}, padded vs "
          f"unpadded mixers {sw32['b_lr1e-12']['mixer_err']:.2e}; study {study['cross_cell']['wall_s']:.1f} s "
          f"+ {study['sequential']['wall_s']:.1f} s; DINOv2 {len(vit['batch_ms'])} batches in "
          f"{vit['embed_ms']:.1f} ms (warm batch {vit['warm_batch_ms']:.2f} ms), kernel vs plain CLS f32 "
          f"{enc['dinov2_rel_float32']:.2e} bf16 {enc['dinov2_rel_bfloat16']:.2e}; ELECTRA padding "
          f"{enc['electra_pad_rel']:.2e}, batching {enc['electra_batch_rel']:.2e}; entry points (s) "
          f"{ {k: v['total_s'] for k, v in entry['report'].items()} }; ring step (25b, float32) "
          f"{mesh['b']['step_ms']['ring']:.1f} ms against {mesh['b']['step_ms']['unsharded']:.1f} ms unsharded; "
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
