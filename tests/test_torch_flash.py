"""Port K4 (multimodalpfn_tpu_torch/ops/flash.py) and the flash branches of the
port's attention against the JAX package's flash kernel
(`multimodalpfn_tpu/ops/pallas_attention.py`) run in TPU interpret mode on the
CPU, and the kernel path's forward without the fused item sublayer against
the JAX package's forward.

On the CPU the port's wrapper runs its plain version, so these tests pin the
plain PyTorch version (which the CUDA kernel is held to on the card) to the
JAX kernel, in float32.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
from multimodalpfn_tpu.models.transformer import forward as jforward
from multimodalpfn_tpu.ops import pallas_attention as jpa
from multimodalpfn_tpu_torch.models import params as tparams
from multimodalpfn_tpu_torch.models.transformer import forward
from multimodalpfn_tpu_torch.ops import attention as tatt
from multimodalpfn_tpu_torch.ops import flash, kernels
from tests.test_torch_forward import MIXERS, _inputs, jax_param_tree, to_port_config

# float32 attention on both sides: the same function up to summation order
# (the JAX kernel sums its online softmax over 128-lane chunks, the plain
# version over whole rows); the JAX package's own flash-vs-XLA bound is 1e-5
# at unit-scale inputs (tests/test_pallas_attention.py)
TOL = dict(rtol=1e-5, atol=1e-5)
# whole float32 forwards whose op orders differ: the golden parity bound
FORWARD_TOL = dict(rtol=2e-4, atol=2e-5)


def _qkv(seed, G, Sq, Skv, d):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(G, Sq, d)).astype(np.float32),
        rng.normal(size=(G, Skv, d)).astype(np.float32),
        rng.normal(size=(G, Skv, d)).astype(np.float32),
    )


# ragged against the JAX kernel's 128-lane tiles; one key; d 8 to 64; the
# edges of the card kernel's tiles (64 keys, 128 query rows a block): one
# row, 63, 64, 65, 127 and 129
@pytest.mark.parametrize("G,Sq,Skv,d", [
    (3, 37, 45, 16), (2, 130, 200, 32), (2, 5, 1, 8),
    (2, 1, 129, 16), (2, 63, 64, 32), (2, 64, 65, 64), (1, 65, 63, 16), (2, 127, 1, 32),
    (1, 129, 127, 64), (2, 128, 129, 32),
])
def test_flash_attention_matches_jax(G, Sq, Skv, d):
    q, k, v = _qkv(0, G, Sq, Skv, d)
    t = lambda a: jnp.asarray(np.swapaxes(a, 1, 2))  # the JAX (G, d, S) layout
    with pltpu.force_tpu_interpret_mode():
        o_j, lse_j = jpa._fwd_impl(
            t(q), t(k), t(v), sm_scale=1.0 / math.sqrt(d),
            block_q=jpa.DEFAULT_BLOCK_Q, block_kv=jpa.DEFAULT_BLOCK_KV,
        )
    o, lse = flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert o.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.swapaxes(np.asarray(o_j), 1, 2), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, 0], **TOL)


# bf16 operands, the card's production precision, at the card kernel's tile
# edges: the plain version rounds the weights to bf16 where the Pallas kernel
# does, so the two agree to a bf16 flip of a weight (2**-6 of the largest
# output); lse is a float32 log-sum of the same scores
@pytest.mark.parametrize("G,Sq,Skv,d", [(2, 129, 65, 32), (2, 64, 127, 16), (1, 65, 129, 64),
                                        (3, 1, 63, 32)])
def test_flash_attention_bf16_matches_jax(G, Sq, Skv, d):
    q, k, v = _qkv(5, G, Sq, Skv, d)
    t = lambda a: jnp.asarray(np.swapaxes(a, 1, 2)).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        o_j, lse_j = jpa._fwd_impl(
            t(q), t(k), t(v), sm_scale=1.0 / math.sqrt(d),
            block_q=jpa.DEFAULT_BLOCK_Q, block_kv=jpa.DEFAULT_BLOCK_KV,
        )
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    o, lse = flash.flash_attention(tb(q), tb(k), tb(v))
    want = np.swapaxes(np.asarray(o_j, dtype=np.float32), 1, 2)
    assert np.abs(o.numpy() - want).max() <= 2.0**-6 * np.abs(want).max()
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, 0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("kv_head0_only", [False, True])
def test_flash_mha_matches_jax(kv_head0_only):
    """The conventional-layout wrapper; multiquery folds the 3 query heads
    into the query axis against KV head 0."""
    rng = np.random.default_rng(1)
    B, h, Sq, Skv, d = 2, 3, 21, 50, 16
    q = rng.normal(size=(B, h, Sq, d)).astype(np.float32)
    k = rng.normal(size=(B, 1 if kv_head0_only else h, Skv, d)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpa.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        kv_head0_only=kv_head0_only))
    got = flash.flash_mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          kv_head0_only=kv_head0_only)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kv_head0_only", [False, True])
def test_mha_flash_branch_matches_plain_branch(kv_head0_only):
    """`mha(use_flash=True)` computes the plain branch's function in float32."""
    rng = np.random.default_rng(2)
    xq = torch.from_numpy(rng.normal(size=(2, 3, 17, 32)).astype(np.float32))
    xkv = torch.from_numpy(rng.normal(size=(2, 3, 40, 32)).astype(np.float32))
    w_qkv = torch.from_numpy(rng.normal(size=(3, 4, 8, 32)).astype(np.float32) * 0.2)
    w_out = torch.from_numpy(rng.normal(size=(4, 8, 32)).astype(np.float32) * 0.2)
    kw = dict(kv_head0_only=kv_head0_only)
    got = tatt.mha(xq, xkv, w_qkv, w_out, use_flash=True, **kw)
    want = tatt.mha(xq, xkv, w_qkv, w_out, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("multiquery", [True, False])
def test_forward_without_fused_item_matches_jax(multiquery, monkeypatch):
    """The kernel path with ``fused_item=False`` (or no multiquery test block)
    runs item attention through K4's wrapper in both blocks of every layer,
    never the plain attention branch; its logits match the JAX package's
    forward."""
    from multimodalpfn_tpu_torch.ops import attention

    calls = []
    real = attention.flash_attention

    def counted(q, k, v, sm_scale=None):
        calls.append((q.shape, k.shape))
        return real(q, k, v, sm_scale)

    monkeypatch.setattr(attention, "flash_attention", counted)
    jcfg = JModelConfig(emsize=32, nhead=4, nhid_factor=2, nlayers=2, n_out=5,
                        mixer=MIXERS["tabular"], compute_dtype="float32", model_seed=3,
                        multiquery_item_attention_for_test_set=multiquery)
    tree = jax_param_tree(jcfg, seed=1)
    x, y, _ = _inputs(9, image=False)
    want = np.asarray(jforward(tree, jcfg, x, y, None, single_eval_pos=y.shape[1]))
    cfg = to_port_config(jcfg, fused_ops=True, use_flash=True, fused_item=False)
    got = forward(tparams.params_from_jax(tree), cfg, torch.from_numpy(x), torch.from_numpy(y),
                  single_eval_pos=y.shape[1])
    np.testing.assert_allclose(got.numpy(), want, **FORWARD_TOL)
    b, S, sep, h, d = x.shape[0], x.shape[1], y.shape[1], 4, 8
    t = 5 + 1  # 5 features + the target token
    test_q = (b * t, h * (S - sep), d) if multiquery else (b * t * h, S - sep, d)
    assert calls == [((b * t * h, sep, d), (b * t * h, sep, d)),
                     (test_q, (b * t * (1 if multiquery else h), sep, d))] * jcfg.nlayers


def test_cpu_wrapper_runs_plain_version_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 9, 11, 8))
    kernels.reset_launches()
    o, lse = flash.flash_attention(q, k, v, sm_scale=0.5)
    o_ref, lse_ref = flash.flash_attention_plain(q, k, v, sm_scale=0.5)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert kernels.LAUNCHES["K4"] == 0


def test_wrapper_refuses_non_cuda_devices_and_bad_shapes():
    """Off the CPU the wrapper launches K4 or raises: a meta tensor is
    neither; mismatched K/V shapes are refused before any launch."""
    q = torch.empty((2, 9, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, torch.empty((2, 5, 16), device="meta"),
                              torch.empty((2, 5, 16), device="meta"))
    with pytest.raises(ValueError, match="v has shape"):
        flash.flash_attention(q, torch.empty((2, 5, 16), device="meta"),
                              torch.empty((2, 6, 16), device="meta"))
    with pytest.raises(ValueError, match="d=24"):
        q24 = torch.empty((2, 9, 24), device="meta")
        flash.flash_attention(q24, torch.empty((2, 5, 24), device="meta"),
                              torch.empty((2, 5, 24), device="meta"))


def test_plain_bf16_close_to_f32():
    """bf16 operands (the card's production precision) stay within bf16
    resolution of the float32 result: outputs are convex sums of unit-scale
    values, and the weights are rounded to 8 bits, so 0.03 abs covers them;
    lse sums exact exponentials of bf16 scores."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2, 33, 70, 16))
    o, lse = flash.flash_attention_plain(q, k, v)
    o16, lse16 = flash.flash_attention_plain(*(a.to(torch.bfloat16) for a in (q, k, v)))
    assert o16.dtype == torch.float32
    np.testing.assert_allclose(o16.numpy(), o.numpy(), atol=0.03)
    np.testing.assert_allclose(lse16.numpy(), lse.numpy(), atol=0.1)
