"""Port K1, K5 and K3 (multimodalpfn_tpu_torch/ops/fused.py) against the JAX
package's Pallas kernels run in TPU interpret mode on the CPU, and the
wrappers' choice of body and operands for the card.

On the CPU the port's wrappers run their plain versions, so these tests pin the
plain PyTorch versions (which the CUDA kernels are held to on the card) to the
JAX kernels, in float32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from multimodalpfn_tpu.ops import pallas_fused as jf
from multimodalpfn_tpu_torch.ops import fused as tf
from multimodalpfn_tpu_torch.ops import kernels

# Both sides are float32 sublayers that end in a LayerNorm (outputs O(1)); they
# differ only in summation order (XLA CPU vs ATen CPU), which the JAX package's
# own fused-vs-XLA tests bound at 3e-6 (tests/test_pallas_fused.py:43).
TOL = dict(rtol=3e-6, atol=3e-6)


def _weights(rng, e, h, d, nhid):
    return (
        rng.normal(size=(3, h, d, e)).astype(np.float32) * 0.1,
        rng.normal(size=(h, d, e)).astype(np.float32) * 0.1,
        rng.normal(size=(e, nhid)).astype(np.float32) * 0.1,
        rng.normal(size=(nhid, e)).astype(np.float32) * 0.1,
    )


# odd t (13) exercises the Pallas sublane padding of the token axis; s = 37 is
# not a multiple of the JAX block (block_rows 16)
@pytest.mark.parametrize("b,t,s,e,h,d", [(2, 13, 37, 32, 4, 8), (1, 7, 20, 16, 2, 8)])
def test_feature_attention_im_matches_jax(b, t, s, e, h, d):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, t, s, e)).astype(np.float32)
    w_qkv, w_out, _, _ = _weights(rng, e, h, d, 8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            jf.fused_feature_attention_ln_im(
                jnp.asarray(x), jnp.asarray(w_qkv), jnp.asarray(w_out), block_rows=16
            )
        )
    got = tf.fused_feature_attention_ln_im(
        torch.from_numpy(x), torch.from_numpy(w_qkv), torch.from_numpy(w_out)
    )
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# sample-major (..., t, e) rows: odd t against the Pallas sublane padding,
# with and without the static key mask
@pytest.mark.parametrize(
    "lead,t,e,h,d,tvc", [((2, 19), 13, 32, 4, 8, None), ((2, 19), 13, 32, 4, 8, 9), ((23,), 7, 16, 2, 8, 1)]
)
def test_feature_attention_matches_jax(lead, t, e, h, d, tvc):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(*lead, t, e)).astype(np.float32)
    w_qkv, w_out, _, _ = _weights(rng, e, h, d, 8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            jf.fused_feature_attention_ln(
                jnp.asarray(x), jnp.asarray(w_qkv), jnp.asarray(w_out),
                token_valid_count=tvc, block_rows=16,
            )
        )
    got = tf.fused_feature_attention_ln(
        torch.from_numpy(x), torch.from_numpy(w_qkv), torch.from_numpy(w_out), tvc
    )
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_item_major_plain_is_sample_major_plain_transposed():
    """K1's plain version is K5's on the transposed rows, exactly."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 6, 11, 16)).astype(np.float32))
    w_qkv, w_out = (torch.from_numpy(a) for a in _weights(rng, 16, 2, 8, 8)[:2])
    im = tf.feature_attention_ln_im_plain(x, w_qkv, w_out)
    sm = tf.feature_attention_ln_plain(x.transpose(1, 2).contiguous(), w_qkv, w_out)
    assert torch.equal(im, sm.transpose(1, 2))


# the last case is the published widths (e = 192, nhid = 768), a few rows
@pytest.mark.parametrize("lead,e,nhid", [((2, 13, 37), 32, 64), ((3, 19), 16, 48), ((2, 7), 192, 768)])
def test_mlp_ln_matches_jax(lead, e, nhid):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(*lead, e)).astype(np.float32)
    _, _, w1, w2 = _weights(rng, e, 2, 8, nhid)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            jf.fused_mlp_ln(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), block_rows=16)
        )
    got = tf.fused_mlp_ln(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2))
    assert got.shape == x.shape
    # the Pallas MLP uses a polynomial erf (max abs error 1.5e-7,
    # pallas_fused.py:101), the port the exact erf: inside the same bound
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# (dtype, e, nhid) -> the body of K3 that runs on the card, or the error the
# wrapper raises: wgmma at e = 64, 128, 192 and mma.sync at e = 32, 96, 160
# (bf16, nhid a multiple of 64); the CUDA cores for float32 and the other
# bf16 widths; no body for an odd e, e past 256, or nhid not a multiple of 4
BODY_CASES = [
    (torch.bfloat16, 192, 768, "wgmma"), (torch.bfloat16, 128, 128, "wgmma"),
    (torch.bfloat16, 64, 64, "wgmma"), (torch.bfloat16, 192, 1280, "wgmma"),
    (torch.bfloat16, 32, 64, "mma_sync"), (torch.bfloat16, 96, 768, "mma_sync"),
    (torch.bfloat16, 160, 128, "mma_sync"),
    (torch.bfloat16, 192, 200, "cuda_cores"), (torch.bfloat16, 192, 96, "cuda_cores"),
    (torch.bfloat16, 48, 128, "cuda_cores"), (torch.bfloat16, 256, 768, "cuda_cores"),
    (torch.bfloat16, 224, 64, "cuda_cores"), (torch.bfloat16, 2, 4, "cuda_cores"),
    (torch.float32, 192, 768, "cuda_cores"), (torch.float32, 64, 128, "cuda_cores"),
    (torch.float32, 32, 64, "cuda_cores"), (torch.float32, 256, 4, "cuda_cores"),
    (torch.bfloat16, 258, 768, ValueError), (torch.float32, 191, 768, ValueError),
    (torch.bfloat16, 0, 64, ValueError), (torch.float32, 192, 2, ValueError),
    (torch.bfloat16, 192, 766, ValueError), (torch.float32, 192, 0, ValueError),
    (torch.float16, 192, 768, TypeError), (torch.float64, 64, 64, TypeError),
]


@pytest.mark.parametrize("dtype,e,nhid,want", BODY_CASES)
def test_mlp_ln_body_choice(dtype, e, nhid, want):
    if isinstance(want, str):
        assert tf.mlp_ln_body(dtype, e, nhid) == want
    else:
        with pytest.raises(want, match="K3"):
            tf.mlp_ln_body(dtype, e, nhid)


def test_mlp_ln_wrapper_refuses_what_no_body_takes():
    """Off the CPU the wrapper asks `mlp_ln_body` before anything else
    launches: widths no body takes raise ValueError, other dtypes
    TypeError."""
    x = torch.empty((3, 5, 48), device="meta")
    with pytest.raises(ValueError, match="nhid=766"):
        tf.fused_mlp_ln(x, torch.empty((48, 766), device="meta"), torch.empty((766, 48), device="meta"))
    x16 = torch.empty((3, 5, 64), device="meta", dtype=torch.float16)
    with pytest.raises(TypeError, match="float16"):
        tf.fused_mlp_ln(x16, torch.empty((64, 64), device="meta"), torch.empty((64, 64), device="meta"))


# (dtype, e, h, d) -> the body of K1, K5, K6a and K6b that runs on the card,
# or the error the wrapper raises: wgmma for bf16 at e = 192, d = 32 and e =
# 64, d = 16 (h·d = e); the CUDA cores for float32 and the other bf16 widths;
# no body for e or h·d not a positive multiple of 4, or d not even
FEAT_BODY_CASES = [
    (torch.bfloat16, 192, 6, 32, "wgmma"), (torch.bfloat16, 64, 4, 16, "wgmma"),
    (torch.bfloat16, 192, 12, 16, "cuda_cores"), (torch.bfloat16, 192, 3, 64, "cuda_cores"),
    (torch.bfloat16, 64, 2, 16, "cuda_cores"), (torch.bfloat16, 96, 6, 16, "cuda_cores"),
    (torch.bfloat16, 128, 4, 32, "cuda_cores"), (torch.bfloat16, 32, 4, 8, "cuda_cores"),
    (torch.float32, 192, 6, 32, "cuda_cores"), (torch.float32, 64, 4, 16, "cuda_cores"),
    (torch.float32, 16, 2, 8, "cuda_cores"),
    (torch.bfloat16, 190, 5, 38, ValueError), (torch.float32, 192, 6, 31, ValueError),
    (torch.bfloat16, 192, 3, 2, ValueError), (torch.float32, 0, 4, 8, ValueError),
    (torch.bfloat16, 192, 0, 32, ValueError),
    (torch.float16, 192, 6, 32, TypeError), (torch.float64, 64, 4, 16, TypeError),
]


@pytest.mark.parametrize("dtype,e,h,d,want", FEAT_BODY_CASES)
def test_feat_attn_body_choice(dtype, e, h, d, want):
    if isinstance(want, str):
        assert tf.feat_attn_body(dtype, e, h, d) == want
    else:
        with pytest.raises(want, match=f"e={e}, h={h}, d={d}" if want is ValueError else "float"):
            tf.feat_attn_body(dtype, e, h, d)


# K7's and K7s' per-row attention: the wgmma body for bf16 at d = 16, 32, 64;
# the warp kernels on the CUDA cores for float32 and bf16 at d = 8; no body
# for another d or dtype
K7_BODY_CASES = [
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 8, "cuda_cores"), (torch.float32, 8, "cuda_cores"),
    (torch.float32, 16, "cuda_cores"), (torch.float32, 32, "cuda_cores"),
    (torch.float32, 64, "cuda_cores"),
    (torch.bfloat16, 12, ValueError), (torch.bfloat16, 128, ValueError), (torch.float32, 4, ValueError),
    (torch.float16, 32, TypeError), (torch.float64, 16, TypeError),
]


@pytest.mark.parametrize("dtype,d,want", K7_BODY_CASES)
def test_feat_attn_bwd_body_choice(dtype, d, want):
    if isinstance(want, str):
        assert tf.feat_attn_bwd_body(dtype, d) == want
    else:
        with pytest.raises(want, match=f"d={d}" if want is ValueError else "float"):
            tf.feat_attn_bwd_body(dtype, d)


@pytest.mark.parametrize("body_dtype", [torch.bfloat16, torch.float32])
def test_feat_attn_operands_match_each_body(body_dtype):
    """`_attn_operands` hands the wgmma body W_qkv with each head's q, k, v
    rows together (row (head·3 + which)·d + c is w_qkv[which, head, c]) and
    the CUDA-core body W_qkv^T (column which·h·d + head·d + c); W_out as
    stored, both in x's dtype."""
    rng = np.random.default_rng(5)
    h, d, e = (6, 32, 192)
    w_qkv = torch.from_numpy(rng.normal(size=(3, h, d, e)).astype(np.float32))
    w_out = torch.from_numpy(rng.normal(size=(h, d, e)).astype(np.float32))
    x = torch.zeros((2, 31, 5, e), dtype=body_dtype)
    body, wqkv, wout = tf._attn_operands("K1", x, w_qkv, w_out, 31, 31)
    want = w_qkv.to(body_dtype)
    assert wqkv.dtype == wout.dtype == body_dtype
    assert torch.equal(wout, w_out.reshape(h * d, e).to(body_dtype))
    if body == "wgmma":
        assert body_dtype == torch.bfloat16 and wqkv.shape == (3 * h * d, e)
        for head, which, c in ((0, 0, 0), (2, 1, 7), (5, 2, 31), (3, 0, 16)):
            assert torch.equal(wqkv[(head * 3 + which) * d + c], want[which, head, c])
    else:
        assert body_dtype == torch.float32 and wqkv.shape == (e, 3 * h * d)
        for head, which, c in ((0, 0, 0), (2, 1, 7), (5, 2, 31)):
            assert torch.equal(wqkv[:, which * h * d + head * d + c], want[which, head, c])


def test_feat_attn_wrappers_refuse_what_no_body_takes():
    """Off the CPU the K1 and K5 wrappers ask `feat_attn_body` before anything
    else launches: widths no body takes raise ValueError naming them, other
    dtypes TypeError."""
    x = torch.empty((1, 5, 9, 36), device="meta")
    w_qkv, w_out = torch.empty((3, 3, 6, 36), device="meta"), torch.empty((3, 6, 36), device="meta")
    with pytest.raises(ValueError, match="e=36, h=3, d=6"):
        tf.fused_feature_attention_ln_im(x, w_qkv, w_out)
    x = torch.empty((1, 5, 9, 18), device="meta")
    w_qkv, w_out = torch.empty((3, 3, 6, 18), device="meta"), torch.empty((3, 6, 18), device="meta")
    with pytest.raises(ValueError, match="e=18, h=3, d=6"):
        tf.fused_feature_attention_ln(x, w_qkv, w_out)
    x16 = torch.empty((1, 5, 9, 16), device="meta", dtype=torch.float16)
    w_qkv, w_out = torch.empty((3, 2, 8, 16), device="meta"), torch.empty((2, 8, 16), device="meta")
    with pytest.raises(TypeError, match="float16"):
        tf.fused_feature_attention_ln_im(x16, w_qkv, w_out)


@pytest.mark.parametrize("name", ["no_attention", "no_weight_feed", "clock"])
def test_feat_attn_probe_diagnostics_apply(name):
    """Each diagnostic build of `tools/torch_feat_attn_probe.py` finds the text
    it edits in `csrc/feat_attn.cu` exactly once, so the tool keeps working
    as the kernel changes (it raises otherwise)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "torch_feat_attn_probe.py"
    spec = importlib.util.spec_from_file_location("torch_feat_attn_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    text = probe.edited_source(name)
    assert text != (path.parents[1] / "multimodalpfn_tpu_torch" / "csrc" / "feat_attn.cu").read_text()


def test_cpu_wrappers_run_plain_versions_without_counting():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(1, 5, 9, 16)).astype(np.float32))
    w_qkv, w_out, w1, w2 = (torch.from_numpy(a) for a in _weights(rng, 16, 2, 8, 32))
    kernels.reset_launches()
    a = tf.fused_feature_attention_ln_im(x, w_qkv, w_out)
    m = tf.fused_mlp_ln(x, w1, w2)
    f = tf.fused_feature_attention_ln(x, w_qkv, w_out, 3)
    assert torch.equal(a, tf.feature_attention_ln_im_plain(x, w_qkv, w_out))
    assert torch.equal(m, tf.mlp_ln_plain(x, w1, w2))
    assert torch.equal(f, tf.feature_attention_ln_plain(x, w_qkv, w_out, 3))
    assert kernels.LAUNCHES["K1"] == kernels.LAUNCHES["K3"] == kernels.LAUNCHES["K5"] == 0


def test_wrappers_refuse_non_cuda_devices():
    """Off the CPU a wrapper launches its kernel or raises: a meta tensor is
    neither, so it raises instead of falling back."""
    x = torch.empty((1, 5, 9, 16), device="meta")
    w_qkv = torch.empty((3, 2, 8, 16), device="meta")
    w_out = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tf.fused_feature_attention_ln_im(x, w_qkv, w_out)
    with pytest.raises(ValueError, match="CUDA"):
        tf.fused_feature_attention_ln(x, w_qkv, w_out)
    with pytest.raises(ValueError, match="token_valid=10"):  # more valid keys than t = 9
        tf.fused_feature_attention_ln(x, w_qkv, w_out, 10)
    with pytest.raises(ValueError, match="CUDA"):
        tf.fused_mlp_ln(x, torch.empty((16, 32), device="meta"), torch.empty((32, 16), device="meta"))


def test_wrappers_check_weight_shapes():
    """Off the CPU a wrapper checks its weights against x before any launch: a
    kernel handed a mismatched width would read past its operands."""
    x = torch.empty((1, 5, 9, 16), device="meta")
    with pytest.raises(ValueError, match="w_qkv"):
        tf.fused_feature_attention_ln_im(
            x, torch.empty((3, 2, 8, 32), device="meta"), torch.empty((2, 8, 16), device="meta")
        )
    with pytest.raises(ValueError, match="w2"):
        tf.fused_mlp_ln(x, torch.empty((16, 32), device="meta"), torch.empty((32, 8), device="meta"))


def test_plain_bf16_close_to_f32():
    """The bf16 plain versions (the card's reference in production precision)
    stay within bf16 resolution of the float32 result: LN outputs are O(1) and
    bf16 keeps 8 bits of mantissa, so 0.06 abs covers the few roundings."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 11, 23, 32)).astype(np.float32))
    w_qkv, w_out, w1, w2 = (torch.from_numpy(a) for a in _weights(rng, 32, 4, 8, 64))
    for fn, args in (
        (tf.feature_attention_ln_im_plain, (w_qkv, w_out)),
        (tf.mlp_ln_plain, (w1, w2)),
    ):
        ref = fn(x, *args)
        got = fn(x.to(torch.bfloat16), *args)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=0.06)
