"""The backwards of K4 and K5 (K11 and K7s) against the JAX package's custom
VJPs, run as `tests/test_pallas_attention.py` and `tests/test_pallas_fused.py`
run them on the CPU (Pallas in TPU interpret mode).

On the CPU the port's wrappers run their plain versions, so these tests pin
the plain PyTorch backwards (which the CUDA kernels are held to on the card)
to the Pallas VJPs, and check that the autograd Functions (`_FlashAttention`,
`_FeatAttnLn`) carry exactly those backwards. Float32; every gradient within
1e-5 of the largest magnitude of its reference.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from multimodalpfn_tpu.ops import pallas_attention as jpa
from multimodalpfn_tpu.ops import pallas_fused as jpf
from multimodalpfn_tpu_torch.ops import flash, kernels
from multimodalpfn_tpu_torch.ops import fused as tf

REL = 1e-5


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), f"{name}: {err} vs scale {np.abs(want).max()}"


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jax_vjp(fn, args, g):
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
        return [np.asarray(c) for c in vjp(jnp.asarray(g))]


def _t(a):
    """(G, S, d) -> the JAX kernel's (G, d, S) layout, and back."""
    return np.swapaxes(np.asarray(a), 1, 2)


# ---- K11 (flash attention backward) ------------------------------------------


# ragged against the Pallas kernel's 128-lane chunks and against K11's 64-row
# tiles, Skv above and below Sq, d 8 and 16
@pytest.mark.parametrize("Sq,Skv,d", [(70, 90, 8), (130, 200, 16), (101, 129, 8), (128, 95, 16)])
def test_flash_backward_plain_matches_jax(Sq, Skv, d):
    rng = np.random.default_rng(Sq + Skv + d)
    G = 3
    q, k, v = (_rand(rng, (G, n, d)) for n in (Sq, Skv, Skv))
    g = _rand(rng, (G, Sq, d))
    want = _jax_vjp(lambda a, b, c: jpa.flash_mha_t(a, b, c), (_t(q), _t(k), _t(v)), _t(g))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = flash.flash_attention_plain(tq, tk, tv)
    plain = flash.flash_attention_bwd_plain(tq, tk, tv, o, lse, torch.from_numpy(g))
    for got, w, name in zip(plain, want, ("dq", "dk", "dv")):
        assert got.dtype == torch.float32
        _close(got.numpy(), _t(w), f"plain {name} vs JAX")
    # the autograd Function carries exactly the plain backward
    leaves = [a.clone().requires_grad_(True) for a in (tq, tk, tv)]
    out, _ = flash.flash_attention(*leaves)
    func = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for got, p in zip(func, plain):
        assert torch.equal(got, p)


@pytest.mark.parametrize("kv_head0_only", [False, True])
def test_flash_mha_backward_matches_jax(kv_head0_only):
    """The conventional-layout wrapper under autograd; multiquery folds the 3
    query heads into the query axis, so KV head 0's dk, dv sum over them."""
    rng = np.random.default_rng(11)
    B, h, Sq, Skv, d = 2, 3, 37, 70, 16
    q = _rand(rng, (B, h, Sq, d))
    k = _rand(rng, (B, 1 if kv_head0_only else h, Skv, d))
    v = _rand(rng, k.shape)
    g = _rand(rng, (B, h, Sq, d))
    want = _jax_vjp(lambda a, b, c: jpa.flash_mha(a, b, c, kv_head0_only=kv_head0_only),
                    (q, k, v), g)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash.flash_mha(*leaves, kv_head0_only=kv_head0_only)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close(a.numpy(), w, f"{name} (kv_head0_only={kv_head0_only})")


def test_flash_backward_wrapper_on_the_cpu_runs_the_plain_version():
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(_rand(rng, (2, n, 8))) for n in (9, 11, 11))
    o, lse = flash.flash_attention_plain(q, k, v, sm_scale=0.5)
    do = torch.from_numpy(_rand(rng, (2, 9, 8)))
    kernels.reset_launches()
    got = flash.flash_attention_bwd(q, k, v, o, lse, do, sm_scale=0.5)
    want = flash.flash_attention_bwd_plain(q, k, v, o, lse, do, sm_scale=0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.LAUNCHES["K11"] == 0


def test_flash_backward_wrapper_refuses_bad_operands():
    """Off the CPU the wrapper launches K11 or raises: mismatched shapes are
    refused before any launch, and a meta tensor is not a CUDA tensor."""
    def meta(*shape):
        return torch.empty(shape, device="meta")

    q, k = meta(2, 9, 16), meta(2, 5, 16)
    with pytest.raises(ValueError, match="lse has shape"):
        flash.flash_attention_bwd(q, k, k, meta(2, 9, 16), meta(2, 8), meta(2, 9, 16))
    with pytest.raises(ValueError, match="d=24"):
        q24, k24 = meta(2, 9, 24), meta(2, 5, 24)
        flash.flash_attention_bwd(q24, k24, k24, q24, meta(2, 9), q24)
    with pytest.raises(ValueError, match="K11: operands must share one CUDA device"):
        flash.flash_attention_bwd(q, k, k, meta(2, 9, 16), meta(2, 9), meta(2, 9, 16))


def test_flash_backward_bf16_rounds_like_the_kernel():
    """bf16 operands: dq, dk, dv come back in bf16, within bf16 resolution of
    the float32 backward (p, ds and the outputs are rounded to 8 bits)."""
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(_rand(rng, (2, n, 16))) for n in (33, 70, 70))
    do = torch.from_numpy(_rand(rng, (2, 33, 16)))
    o, lse = flash.flash_attention_plain(q, k, v)
    f32 = flash.flash_attention_bwd_plain(q, k, v, o, lse, do)
    qb, kb, vb = (a.to(torch.bfloat16) for a in (q, k, v))
    ob, lseb = flash.flash_attention_plain(qb, kb, vb)
    bf = flash.flash_attention_bwd_plain(qb, kb, vb, ob, lseb, do)
    for a, b in zip(bf, f32):
        assert a.dtype == torch.bfloat16
        assert (a.float() - b).abs().max() <= 0.05 * b.abs().max()


# ---- K7s (sample-major feature attention backward) -----------------------------


# rows ragged against the Pallas block of 32, three lead axes, t 5 to 9;
# then the head widths of K7s' wgmma body (d = 16, 64) at the token counts
# where its 64-row tiles change packing (32, 33) up to the JAX gate (48),
# with (h, e) = (3, 24) at d = 8, 16, (2, 48) at 64
@pytest.mark.parametrize("lead,t,d", [
    pytest.param((2, 37), 5, 8, id="lead0-5"), pytest.param((1, 3, 20), 9, 8, id="lead1-9"),
    pytest.param((2, 37), 7, 8, id="lead2-7"), pytest.param((1, 33), 6, 8, id="lead3-6"),
    ((1, 3), 32, 16), ((2, 2), 33, 16), ((1, 2), 48, 16), ((1, 5), 7, 64), ((1, 3), 32, 64),
    ((2, 2), 33, 64), ((1, 2), 48, 64),
])
def test_feature_attention_backward_matches_jax(lead, t, d):
    rng = np.random.default_rng(sum(lead) * 10 + t + (d != 8) * d * 1000)
    h, e = (2, 48) if d == 64 else (3, 24)
    x = _rand(rng, (*lead, t, e))
    w_qkv = _rand(rng, (3, h, d, e), 0.3)
    w_out = _rand(rng, (h, d, e), 0.3)
    g = _rand(rng, (*lead, t, e))
    want = _jax_vjp(jpf.fused_feature_attention_ln, (x, w_qkv, w_out), g)
    plain = tf.feature_attention_ln_bwd_plain(*map(torch.from_numpy, (x, w_qkv, w_out, g)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w_qkv, w_out)]
    func = torch.autograd.grad(tf.fused_feature_attention_ln(*leaves), leaves, torch.from_numpy(g))
    auto = torch.autograd.grad(tf.feature_attention_ln_plain(*leaves), leaves, torch.from_numpy(g))
    for i, name in enumerate(("dx", "dw_qkv", "dw_out")):
        _close(plain[i].numpy(), want[i], f"plain {name} vs JAX")
        _close(plain[i].numpy(), auto[i].numpy(), f"plain {name} vs autograd")
        assert torch.equal(func[i], plain[i]), f"Function {name} is not the plain backward"


def test_feature_attention_backward_wrapper_on_the_cpu():
    """The K7s wrapper runs the plain version on the CPU without counting;
    the item-major plain backward is the sample-major one transposed."""
    rng = np.random.default_rng(14)
    x, g = (torch.from_numpy(_rand(rng, (2, 6, 5, 16))) for _ in range(2))
    w_qkv = torch.from_numpy(_rand(rng, (3, 2, 8, 16), 0.3))
    w_out = torch.from_numpy(_rand(rng, (2, 8, 16), 0.3))
    kernels.reset_launches()
    got = tf.feature_attention_ln_bwd(x, w_qkv, w_out, g)
    assert kernels.LAUNCHES["K7s"] == 0
    want = tf.feature_attention_ln_bwd_plain(x, w_qkv, w_out, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    im = tf.feature_attention_ln_im_bwd_plain(x.transpose(1, 2).contiguous(), w_qkv, w_out,
                                              g.transpose(1, 2).contiguous())
    torch.testing.assert_close(im[0].transpose(1, 2), got[0], rtol=0, atol=1e-6)
    for a, b in zip(im[1:], got[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="K7s: operands must share one CUDA device"):
        tf.feature_attention_ln_bwd(*(torch.empty(a.shape, device="meta") for a in (x, w_qkv, w_out, g)))

