"""Backward ops of the port's training path against the JAX package's custom
VJPs (Pallas kernels in TPU interpret mode on the CPU).

On the CPU the port's backward wrappers run their plain versions, so these
tests pin the plain PyTorch backwards (which the CUDA kernels K7, K8, K9 and
K10 are held to on the card) to the JAX package's fused backwards, and check
them against ``torch.autograd.grad`` of the plain forwards and through the
``autograd.Function`` wrappers. Float32; every gradient within 1e-5 of the
largest magnitude of its reference.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from multimodalpfn_tpu.ops import pallas_fused as jpf
from multimodalpfn_tpu.ops import pallas_item_fused as jpif
from multimodalpfn_tpu_torch.ops import fused as tf
from multimodalpfn_tpu_torch.ops import item_fused as tif

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


def _torch_grads(fn, args, g):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    return [c.numpy() for c in torch.autograd.grad(out, ts, torch.from_numpy(g))]


# ---- K7 (item-major feature attention backward) ------------------------------


# (b, t, s): ragged rows against the Pallas block of 32, ragged tokens, one
# row; then the head widths of K7's wgmma body (d = 16, 64) at the token
# counts where its 64-row tiles change packing (32: two samples, 33: one,
# 48: the JAX gate's most), with (h, e) = (3, 24) at d = 8, 16, (2, 48) at 64
@pytest.mark.parametrize("b,t,s,d", [
    pytest.param(2, 8, 37, 8, id="2-8-37"), pytest.param(1, 13, 32, 8, id="1-13-32"),
    pytest.param(2, 5, 1, 8, id="2-5-1"),
    (1, 32, 3, 16), (1, 33, 4, 16), (1, 48, 2, 16), (2, 5, 3, 64), (1, 32, 3, 64),
    (1, 33, 2, 64), (1, 48, 3, 64),
])
def test_feature_attention_im_backward_matches_jax(b, t, s, d):
    rng = np.random.default_rng(b * 100 + t * 10 + s + (d != 8) * d * 1000)
    h, e = (2, 48) if d == 64 else (3, 24)
    x = _rand(rng, (b, t, s, e))
    w_qkv = _rand(rng, (3, h, d, e), 0.3)
    w_out = _rand(rng, (h, d, e), 0.3)
    g = _rand(rng, (b, t, s, e))
    want = _jax_vjp(jpf.fused_feature_attention_ln_im, (x, w_qkv, w_out), g)
    plain = tf.feature_attention_ln_im_bwd_plain(*map(torch.from_numpy, (x, w_qkv, w_out, g)))
    auto = _torch_grads(tf.feature_attention_ln_im_plain, (x, w_qkv, w_out), g)
    func = _torch_grads(tf.fused_feature_attention_ln_im, (x, w_qkv, w_out), g)
    for i, name in enumerate(("dx", "dw_qkv", "dw_out")):
        _close(plain[i].numpy(), want[i], f"plain {name} vs JAX")
        _close(plain[i].numpy(), auto[i], f"plain {name} vs autograd")
        _close(func[i], want[i], f"Function {name} vs JAX")
        _close(func[i], auto[i], f"Function {name} vs autograd")


# the flagship's widths (e = 192, h = 6, d = 32) with a few rows: ragged
# samples against the Pallas block, ragged tokens, and the token counts
# where K7's 64-row tiles change packing (32, 33) up to the JAX gate (48)
@pytest.mark.parametrize("b,t,s", [(1, 30, 3), (1, 7, 5), (1, 32, 3), (1, 33, 2), (1, 48, 2)])
def test_feature_attention_im_backward_matches_jax_at_flagship_widths(b, t, s):
    rng = np.random.default_rng(1000 + t * 10 + s)
    e, h, d = 192, 6, 32
    x = _rand(rng, (b, t, s, e))
    w_qkv = _rand(rng, (3, h, d, e), e**-0.5)
    w_out = _rand(rng, (h, d, e), (h * d) ** -0.5)
    g = _rand(rng, (b, t, s, e))
    want = _jax_vjp(jpf.fused_feature_attention_ln_im, (x, w_qkv, w_out), g)
    plain = tf.feature_attention_ln_im_bwd_plain(*map(torch.from_numpy, (x, w_qkv, w_out, g)))
    for i, name in enumerate(("dx", "dw_qkv", "dw_out")):
        _close(plain[i].numpy(), want[i], f"plain {name} vs JAX")


# ---- K8 (MLP + LN backward) --------------------------------------------------


# rows 3·37 = 111 against the Pallas block of 16: ragged tail; 1 row
@pytest.mark.parametrize("lead", [(3, 37), (1, 1)])
def test_mlp_backward_matches_jax(lead):
    rng = np.random.default_rng(sum(lead))
    e, H = 24, 96
    x = _rand(rng, (*lead, e))
    w1 = _rand(rng, (e, H), 0.2)
    w2 = _rand(rng, (H, e), 0.2)
    g = _rand(rng, (*lead, e))
    want = _jax_vjp(lambda *a: jpf.fused_mlp_ln(*a, block_rows=16), (x, w1, w2), g)
    plain = tf.mlp_ln_bwd_plain(*map(torch.from_numpy, (x, w1, w2, g)))
    auto = _torch_grads(tf.mlp_ln_plain, (x, w1, w2), g)
    func = _torch_grads(tf.fused_mlp_ln, (x, w1, w2), g)
    for i, name in enumerate(("dx", "dw1", "dw2")):
        _close(plain[i].numpy(), want[i], f"plain {name} vs JAX")
        _close(plain[i].numpy(), auto[i], f"plain {name} vs autograd")
        _close(func[i], want[i], f"Function {name} vs JAX")
        _close(func[i], auto[i], f"Function {name} vs autograd")


# the flagship's widths (e = 192, nhid = 768) with a few rows, ragged
# against the Pallas block of 16
@pytest.mark.parametrize("lead", [(1, 30, 3), (2, 9)])
def test_mlp_backward_matches_jax_at_flagship_widths(lead):
    rng = np.random.default_rng(2000 + sum(lead))
    e, H = 192, 768
    x = _rand(rng, (*lead, e))
    w1 = _rand(rng, (e, H), e**-0.5)
    w2 = _rand(rng, (H, e), H**-0.5)
    g = _rand(rng, (*lead, e))
    want = _jax_vjp(lambda *a: jpf.fused_mlp_ln(*a, block_rows=16), (x, w1, w2), g)
    plain = tf.mlp_ln_bwd_plain(*map(torch.from_numpy, (x, w1, w2, g)))
    for i, name in enumerate(("dx", "dw1", "dw2")):
        _close(plain[i].numpy(), want[i], f"plain {name} vs JAX")


# ---- K10 + K9 (item-attention sublayer backward) -----------------------------


def _sublayer_plain(x, w_qkv, w_out, sep):
    o, _ = tif.item_attention_core_plain(x, w_qkv, sep)
    return tif.item_epilogue_ln_plain(x, o, w_out)


def _sublayer_plain_bwd(x, w_qkv, w_out, g, sep):
    o, lse = tif.item_attention_core_plain(x, w_qkv, sep)
    du, do, delta, dw_out = tif.item_epilogue_bwd_plain(x, o, w_out, g)
    dx, dw_qkv = tif.item_attention_bwd_plain(x, w_qkv, do, delta, lse, sep, du)
    return dx, dw_qkv, dw_out


# ragged rows and a ragged KV tail; one train row; no test rows; one test row
@pytest.mark.parametrize("S,sep", [(70, 48), (9, 1), (40, 40), (41, 40)])
def test_item_sublayer_backward_matches_jax(S, sep):
    rng = np.random.default_rng(S * 7 + sep)
    G, e, h, d = 3, 16, 2, 8
    x = _rand(rng, (G, S, e))
    w_qkv = _rand(rng, (3, h, d, e), 0.3)
    w_out = _rand(rng, (h, d, e), 0.3)
    g = _rand(rng, (G, S, e))
    want = _jax_vjp(
        lambda *a: jpif.fused_item_sublayer(*a, single_eval_pos=sep, compute_dtype=jnp.float32),
        (x, w_qkv, w_out), g,
    )
    plain = _sublayer_plain_bwd(*map(torch.from_numpy, (x, w_qkv, w_out, g)), sep)
    auto = _torch_grads(lambda *a: _sublayer_plain(*a, sep), (x, w_qkv, w_out), g)
    func = _torch_grads(
        lambda *a: tif.fused_item_sublayer(*a, single_eval_pos=sep, compute_dtype=torch.float32),
        (x, w_qkv, w_out), g,
    )
    for i, name in enumerate(("dx", "dw_qkv", "dw_out")):
        _close(plain[i].numpy(), want[i], f"plain {name} vs JAX")
        _close(plain[i].numpy(), auto[i], f"plain {name} vs autograd")
        _close(func[i], want[i], f"Function {name} vs JAX")
        _close(func[i], auto[i], f"Function {name} vs autograd")


def test_epilogue_delta_matches_its_definition():
    """K10's delta is Σ_d do·o per head from the unrounded do."""
    rng = np.random.default_rng(3)
    G, S, e, h, d = 2, 11, 16, 2, 8
    x, o = (torch.from_numpy(_rand(rng, (G, S, n))) for n in (e, h * d))
    w_out = torch.from_numpy(_rand(rng, (h, d, e), 0.3))
    g = torch.from_numpy(_rand(rng, (G, S, e)))
    _, do, delta, _ = tif.item_epilogue_bwd_plain(x, o, w_out, g)
    want = (do * o).reshape(G, S, h, d).sum(-1).transpose(1, 2)
    torch.testing.assert_close(delta, want, rtol=0, atol=1e-5)


def test_bf16_plain_backwards_round_where_the_kernels_do():
    """In bf16 the plain backwards return the compute dtype for dx and float32
    weight cotangents, and stay within bf16 tolerance of the float32 ones."""
    rng = np.random.default_rng(4)
    b, t, s, e, h, d = 1, 6, 9, 16, 2, 8
    x = torch.from_numpy(_rand(rng, (b, t, s, e)))
    w_qkv = torch.from_numpy(_rand(rng, (3, h, d, e), 0.3))
    w_out = torch.from_numpy(_rand(rng, (h, d, e), 0.3))
    g = torch.from_numpy(_rand(rng, (b, t, s, e)))
    f32 = tf.feature_attention_ln_im_bwd_plain(x, w_qkv, w_out, g)
    bf = tf.feature_attention_ln_im_bwd_plain(
        x.bfloat16(), w_qkv, w_out, g.bfloat16()
    )
    assert bf[0].dtype == torch.bfloat16 and bf[1].dtype == torch.float32
    for a, b_ in zip(bf, f32):
        assert (a.float() - b_).abs().max() <= 0.05 * b_.abs().max()


def test_inference_only_kernels_forbid_autograd():
    """K5 with ``token_valid_count``, K6a and K6b have no backward kernel (the
    JAX package gives them no VJP): off the CPU their wrappers refuse inputs
    that require grad before any launch. K4 and the unmasked K5 have one
    (K11, K7s): they go through their autograd Functions instead, which on a
    meta tensor stop at the device check, not at the autograd refusal."""
    from multimodalpfn_tpu_torch.ops import flash, kernels

    def meta(*shape):
        return torch.empty(shape, device="meta").requires_grad_(True)

    x, w_qkv, w_out = meta(2, 5, 7, 32), meta(3, 4, 8, 32), meta(4, 8, 32)
    mask = torch.ones((2, 7), dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="K5 has no backward kernel"):
        tf.fused_feature_attention_ln(x, w_qkv, w_out, token_valid_count=6)
    with pytest.raises(NotImplementedError, match="K6b has no backward kernel"):
        tf.fused_feature_attention_ln(x, w_qkv, w_out, key_mask=mask[:, None])
    xi = meta(2, 7, 5, 32)  # (b, t, s, e)
    with pytest.raises(NotImplementedError, match="K6a has no backward kernel"):
        tf.fused_feature_attention_ln_im(xi, w_qkv, w_out, key_mask=mask)
    with pytest.raises(ValueError, match="K5: operands must share one CUDA device"):
        tf.fused_feature_attention_ln(x, w_qkv, w_out)
    q = meta(2, 9, 16)
    with pytest.raises(ValueError, match="K4: operands must share one CUDA device"):
        flash.flash_attention(q, q, q)
    t = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K6a has no backward kernel"):
        kernels.forbid_autograd("K6a", t)
    with torch.no_grad():
        kernels.forbid_autograd("K6a", t)
    kernels.forbid_autograd("K6a", t.detach())


def test_k4_and_unmasked_k5_return_gradients():
    """K4 and the unmasked K5 are differentiable: on the CPU their autograd
    Functions return the plain backwards' gradients (K11's and K7s'), for
    every input, and count no launch."""
    from multimodalpfn_tpu_torch.ops import flash, kernels

    rng = np.random.default_rng(6)
    kernels.reset_launches()
    q, k, v = (torch.from_numpy(_rand(rng, (2, n, 8))).requires_grad_(True) for n in (9, 13, 13))
    o, lse = flash.flash_attention(q, k, v)
    assert not lse.requires_grad
    do = torch.from_numpy(_rand(rng, (2, 9, 8)))
    got = torch.autograd.grad(o, (q, k, v), do)
    want = flash.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o.detach(),
                                           lse, do)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    x = torch.from_numpy(_rand(rng, (2, 5, 7, 16))).requires_grad_(True)
    w_qkv = torch.from_numpy(_rand(rng, (3, 2, 8, 16), 0.3)).requires_grad_(True)
    w_out = torch.from_numpy(_rand(rng, (2, 8, 16), 0.3)).requires_grad_(True)
    g = torch.from_numpy(_rand(rng, (2, 5, 7, 16)))
    out = tf.fused_feature_attention_ln(x, w_qkv, w_out)
    got = torch.autograd.grad(out, (x, w_qkv, w_out), g)
    want = tf.feature_attention_ln_bwd_plain(x.detach(), w_qkv.detach(), w_out.detach(), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not any(kernels.LAUNCHES.values())
