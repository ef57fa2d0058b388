"""The operation and byte counts of `portbench/work/` against cases worked
by hand, on a configuration small enough to count: e = 4, 2 heads of 2,
nhid 8, one layer, one MGM head over 4-wide embeddings, one CAP query."""

from __future__ import annotations

import pytest

from portbench.work import attention, forward, peaks

ARCH = {"emsize": 4, "nhead": 2, "nhid_factor": 2, "nlayers": 1, "features_per_group": 1,
        "n_out": 3, "mixer": {"mgm_heads": 1, "cap_heads": 1, "in_dim": 4}}


def test_tokens():
    # 1 feature + 1 CAP token + the target
    assert forward.tokens(ARCH, 1) == 3


def test_item_attention_flops():
    # t = 2 columns, 3 train rows, 1 test row, e = 4, 2 heads of d = 2.
    # Projections a column: q, k, v of 3 rows (3 · 2·3·4·4 = 288) and q of
    # the test row (2·1·4·4 = 32): 320, two columns 640. Scores and weighted
    # values a column: train 2 heads · 2 products · 2·3·3·2 = 144, test
    # 2 heads · 2 products · 2·1·3·2 = 48: 192, two columns 384.
    assert forward.item_attention_flops(4, 2, 3, 1) == 640 + 384


def test_layer_flops():
    # 4 rows of t = 2 tokens (1 feature + 0 mixer tokens + target).
    # Feature attention a row: qkv 2·2·4·12 = 192, out 2·2·4·4 = 64, scores
    # and values 2 heads · 2 · 2·2·2·2 = 64: 320, four rows 1280. Item
    # attention 1024 plus its out-projection 2·8·4·4 = 256. MLP two products
    # of 2·8·4·8 = 512: 1024.
    assert forward.layer_flops(ARCH, 2, 3, 1, cached=False) == 1280 + 1280 + 1024
    # cached: the test row alone; feature attention 320; q 2·2·4·4 = 64,
    # scores and values 4·2·4·1·3 = 96, out 64; MLP 2 · 2·2·4·8 = 256
    assert forward.layer_flops(ARCH, 2, 3, 1, cached=True) == 320 + 64 + 96 + 64 + 256


def test_mixer_flops():
    # per row: MGM 2·1·1·(4·4 + 2·4) = 48; CAP keys/values 2·1·4·8 = 64,
    # scores and values 4·1·1·4 = 16, out 2·1·4·4 = 32, FFN 8·1·4·4 = 128;
    # once: the query's two projections 4·1·4·4 = 64
    assert forward.mixer_flops(ARCH, 2, 1) == 2 * (48 + 64 + 16 + 32 + 128) + 64


def test_request_and_iteration_flops():
    f = 1  # one feature: t = 3
    member = (2 * 4 * f * 2 * 4 + 2 * 4 * 2 * 4 + 2 * 2 * 1 * 4
              + forward.layer_flops(ARCH, 3, 3, 1, False) + 2 * 1 * 4 * 8 + 2 * 1 * 8 * 3)
    assert forward.member_flops(ARCH, f, 3, 1) == member
    shapes = {"members": [f, f], "image_tokens": 1, "train_rows": 3, "cached": False}
    assert forward.request_flops(ARCH, shapes, 1) == 2 * member + forward.mixer_flops(ARCH, 4, 1)
    it = {"features": f, "image_tokens": 1, "episode_train": 3, "episode_test": 1,
          "val_train": 3, "val_test": 1}
    assert forward.iteration_flops(ARCH, it) == 4 * (member + forward.mixer_flops(ARCH, 4, 1))


def test_attention_work():
    # t = 3 (one feature), 3 train rows, 1 test row: 12 rows of x and o in
    # bf16, W_qkv 3·4·4 in bf16, the lse of 12 rows · 2 heads in float32
    flops, nbytes = attention.item_attention_forward(ARCH, 1, 3, 1)
    assert flops == forward.item_attention_flops(4, 3, 3, 1)
    assert nbytes == 2 * (2 * 12 * 4 + 3 * 16) + 4 * 12 * 2
    # backward: 4 products of the train block 8·3·4·9, of the test block 8·3·4·3
    flops, nbytes = attention.item_attention_backward(ARCH, 1, 3, 1)
    assert flops == 8 * 3 * 4 * 9 + 8 * 3 * 4 * 3
    assert nbytes == 2 * (2 * 12 * 4 + 2 * 9 * 4 + 12 * 4 + 2 * 9 * 4) + 4 * 12 * 2
    # cached: q and o of 3 · 1 rows, head 0's k and v of 3 · 3 rows of d = 2
    flops, nbytes = attention.cached_attention(ARCH, 1, 3, 1)
    assert flops == 4 * 3 * 4 * 1 * 3
    assert nbytes == 2 * (2 * 3 * 1 * 4 + 2 * 3 * 3 * 2)


def test_bound():
    assert peaks.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
