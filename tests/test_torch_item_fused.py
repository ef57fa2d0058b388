"""Port K2a + K2b (multimodalpfn_tpu_torch/ops/item_fused.py) against the JAX
package's fused item-attention sublayer run in TPU interpret mode on the CPU.

On the CPU the port's wrappers run their plain versions, so these tests pin the
plain PyTorch versions (which the CUDA kernels are held to on the card) to the
Pallas kernels, in float32, including the per-head lse of both regions and the
train-only case (n_test = 0).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from multimodalpfn_tpu.ops import pallas_item_fused as pif
from multimodalpfn_tpu_torch.ops import attention as tatt
from multimodalpfn_tpu_torch.ops import item_fused as tif

# float32 online-softmax attention + LN on both sides; the JAX package bounds
# its own fused-vs-XLA item attention at 2e-5 abs (tests/test_pallas_item_fused.py:41)
ATOL = 2e-5


def _make(seed, lead=(2, 3), S=72, sep=48, e=16, h=2, d=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, S, e)).astype(np.float32)
    w_qkv = (rng.standard_normal((3, h, d, e)) * 0.2).astype(np.float32)
    w_out = (rng.standard_normal((h, d, e)) * 0.2).astype(np.float32)
    return x, w_qkv, w_out


# S=70: the epilogue's row tail is ragged; S=48=sep: no test rows;
# sep=128: the Pallas kernel's KV tail chunk is unmasked
@pytest.mark.parametrize("S,sep", [(70, 48), (48, 48), (160, 128)])
def test_sublayer_matches_jax(S, sep):
    x, w_qkv, w_out = _make(S + sep, lead=(3,), S=S, sep=sep)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            pif.fused_item_sublayer(
                jnp.asarray(x), jnp.asarray(w_qkv), jnp.asarray(w_out),
                single_eval_pos=sep, compute_dtype=jnp.float32,
            )
        )
    got = tif.fused_item_sublayer(
        torch.from_numpy(x), torch.from_numpy(w_qkv), torch.from_numpy(w_out),
        single_eval_pos=sep, compute_dtype=torch.float32,
    )
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


# the card kernel's tile edges (64 keys, 128 query rows a block): sep at 1,
# 64, 65 and 128, with no test row, one, or 65
K2A_EDGES = [(sep + n_test, sep, 16 if i % 2 else 32)
             for i, (sep, n_test) in enumerate((sep, n) for sep in (1, 64, 65, 128) for n in (0, 1, 65))]


@pytest.mark.parametrize("S,sep,d", [pytest.param(72, 48, 8, id="72-48"),
                                     pytest.param(48, 48, 8, id="48-48"), *K2A_EDGES])
def test_attention_core_and_lse_match_jax(S, sep, d):
    x, w_qkv, w_out = _make(7, lead=(4,), S=S, sep=sep, d=d)
    G, _, e = x.shape
    _, h, d, _ = w_qkv.shape
    with pltpu.force_tpu_interpret_mode():
        o_mid, lse_tr, lse_te = pif._fwd_call(
            jnp.asarray(x), jnp.asarray(w_qkv.reshape(3, h * d, e)), sep,
            h=h, d=d, sm_scale=1.0 / math.sqrt(d),
        )
    o, lse = tif.item_attention_core(torch.from_numpy(x), torch.from_numpy(w_qkv), sep)
    # the Pallas output is (G, h·d, S); the port keeps the natural (G, S, h·d)
    np.testing.assert_allclose(o.numpy(), np.swapaxes(np.asarray(o_mid), 1, 2), atol=ATOL)
    # lse = max + log(sum) of O(1) logits: float32 rounding only
    np.testing.assert_allclose(lse[..., :sep].numpy(), np.asarray(lse_tr)[..., :sep], atol=1e-5)
    if S > sep:
        np.testing.assert_allclose(
            lse[..., sep:].numpy(), np.asarray(lse_te)[..., : S - sep], atol=1e-5
        )


# bf16 operands: the plain version rounds the projections and the weights
# where the Pallas kernel does, so the two agree to a bf16 flip (2**-6 of the
# largest output); lse is a float32 log-sum of the same scores
@pytest.mark.parametrize("S,sep,d", [(130, 65, 32), (129, 128, 16), (64, 64, 32), (66, 1, 16)])
def test_attention_core_bf16_matches_jax(S, sep, d):
    x, w_qkv, _ = _make(13, lead=(3,), S=S, sep=sep, d=d)
    G, _, e = x.shape
    _, h, d, _ = w_qkv.shape
    with pltpu.force_tpu_interpret_mode():
        o_mid, lse_tr, lse_te = pif._fwd_call(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(w_qkv.reshape(3, h * d, e), jnp.bfloat16),
            sep, h=h, d=d, sm_scale=1.0 / math.sqrt(d),
        )
    o, lse = tif.item_attention_core(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w_qkv), sep)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want = np.swapaxes(np.asarray(o_mid, dtype=np.float32), 1, 2)
    assert np.abs(o.float().numpy() - want).max() <= 2.0**-6 * np.abs(want).max()
    np.testing.assert_allclose(lse[..., :sep].numpy(), np.asarray(lse_tr)[..., :sep], rtol=0, atol=1e-5)
    if S > sep:
        np.testing.assert_allclose(lse[..., sep:].numpy(), np.asarray(lse_te)[..., : S - sep],
                                   rtol=0, atol=1e-5)


def test_plain_core_matches_plain_item_attention():
    """K2a + out-projection equals the plain two-block `item_attention`
    (train self-attention, test rows on KV head 0)."""
    x, w_qkv, w_out = _make(9, lead=(2,), S=40, sep=25)
    xt, wq, wo = (torch.from_numpy(a) for a in (x, w_qkv, w_out))
    o, _ = tif.item_attention_core(xt, wq, 25)
    got = o @ wo.reshape(-1, x.shape[-1])
    want = tatt.item_attention(xt, wq, wo, single_eval_pos=25)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_plain_chunks_groups_like_one_pass(monkeypatch):
    """The plain version bounds its score memory by chunking groups; chunking
    must not change the result."""
    x, w_qkv, _ = _make(11, lead=(5,), S=30, sep=20)
    xt, wq = torch.from_numpy(x), torch.from_numpy(w_qkv)
    o1, l1 = tif.item_attention_core_plain(xt, wq, 20)
    monkeypatch.setattr(tif, "_PLAIN_SCORE_BYTES", 1)  # one group per chunk
    o2, l2 = tif.item_attention_core_plain(xt, wq, 20)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


def test_gate_admits_any_train_split():
    kw = dict(fused_item=True, multiquery_test=True, ring_axis=None)
    assert tatt.can_use_fused_item(1, 0, **kw)
    assert tatt.can_use_fused_item(8000, 5000, **kw)
    assert not tatt.can_use_fused_item(0, 10, **kw)
    assert not tatt.can_use_fused_item(600, 10, fused_item=True, multiquery_test=False, ring_axis=None)
    assert not tatt.can_use_fused_item(600, 10, fused_item=False, multiquery_test=True, ring_axis=None)
