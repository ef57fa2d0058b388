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


# the widths of K2b's wgmma body on the card, (e, h·d): square at 64 and at
# the published 192, and h·d below e; S = 130 leaves the card's 64-row units
# and the Pallas kernel's 512-row block ragged
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,hd", [(64, 64), (192, 192), (192, 64)])
def test_epilogue_plain_matches_jax(e, hd, dtype):
    """`item_epilogue_ln_plain` against the Pallas `_epi_fwd_call` in
    interpret mode: float32 within 1e-5 of the largest output (summation
    order), bf16 within two bf16 ulps of it (2**-6: the kernels sum the
    same bf16 products in float32 in another order, and each output is
    rounded to bf16 once)."""
    rng = np.random.default_rng(e + hd)
    G, S = 2, 130
    x = rng.standard_normal((G, S, e)).astype(np.float32)
    o = rng.standard_normal((G, S, hd)).astype(np.float32)
    w = (rng.standard_normal((hd, e)) * hd**-0.5).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            pif._epi_fwd_call(jnp.asarray(x, jdt), jnp.asarray(np.swapaxes(o, 1, 2), jdt), jnp.asarray(w, jdt)),
            dtype=np.float32,
        )
    got = tif.item_epilogue_ln(torch.from_numpy(x).to(tdt), torch.from_numpy(o).to(tdt),
                               torch.from_numpy(w).reshape(hd // 8, 8, e))
    assert got.dtype == tdt and got.shape == (G, S, e)
    bound = 1e-5 if dtype == "float32" else 2.0**-6
    assert np.abs(got.float().numpy() - want).max() <= bound * np.abs(want).max()


# (dtype, e, h·d) -> the body of K2b that runs on the card, or the error the
# wrapper raises: wgmma for bf16 at e = 64, 128, 192 with h·d a multiple of
# 64 up to 256; mma.sync at the other multiples of 32 up to 192 with h·d a
# multiple of 8; the CUDA cores for float32 and the other bf16 widths
EPI_BODY_CASES = [
    (torch.bfloat16, 192, 192, "wgmma"), (torch.bfloat16, 192, 64, "wgmma"),
    (torch.bfloat16, 128, 128, "wgmma"), (torch.bfloat16, 64, 256, "wgmma"),
    (torch.bfloat16, 64, 96, "mma_sync"), (torch.bfloat16, 96, 96, "mma_sync"),
    (torch.bfloat16, 192, 320, "mma_sync"), (torch.bfloat16, 32, 8, "mma_sync"),
    (torch.bfloat16, 160, 48, "mma_sync"),
    (torch.bfloat16, 48, 40, "cuda_cores"), (torch.bfloat16, 224, 64, "cuda_cores"),
    (torch.bfloat16, 192, 36, "cuda_cores"), (torch.bfloat16, 256, 256, "cuda_cores"),
    (torch.float32, 192, 192, "cuda_cores"), (torch.float32, 64, 64, "cuda_cores"),
    (torch.bfloat16, 257, 64, ValueError), (torch.float32, 0, 64, ValueError),
    (torch.bfloat16, 192, 2048, ValueError), (torch.float32, 192, 0, ValueError),
    (torch.float16, 192, 192, TypeError), (torch.float64, 64, 64, TypeError),
]


@pytest.mark.parametrize("dtype,e,hd,want", EPI_BODY_CASES)
def test_epilogue_body_choice(dtype, e, hd, want):
    if isinstance(want, str):
        assert tif.item_epilogue_body(dtype, e, hd) == want
    else:
        with pytest.raises(want, match="K2b"):
            tif.item_epilogue_body(dtype, e, hd)


def test_epilogue_wrapper_refuses_what_no_body_takes():
    """Off the CPU the wrapper asks `item_epilogue_body` before anything
    launches: widths no body takes raise ValueError, other dtypes
    TypeError."""
    x = torch.empty((3, 5, 288), device="meta", dtype=torch.bfloat16)
    o = torch.empty((3, 5, 64), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="e=288"):
        tif.item_epilogue_ln(x, o, torch.empty((64, 288), device="meta"))
    x16 = torch.empty((3, 5, 64), device="meta", dtype=torch.float16)
    with pytest.raises(TypeError, match="float16"):
        tif.item_epilogue_ln(x16, x16, torch.empty((64, 64), device="meta"))


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


def _global_functions() -> list[str]:
    """The qualified name (named namespaces only, as the profiler prints
    them) of every ``__global__`` function in the port's CUDA sources."""
    import re
    from pathlib import Path

    csrc = Path(tif.__file__).resolve().parents[1] / "csrc"
    kernel = re.compile(r"__global__\s+(?:static\s+)?void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    names = []
    for path in sorted(csrc.glob("*.cu*")):
        text = path.read_text()
        # namespace opens and closes, and kernels, in the order they appear
        events = sorted([(m.start(), "open", m.group(1))
                         for m in re.finditer(r"^namespace (\w*)\s*\{", text, re.M)]
                        + [(m.start(), "close", "") for m in re.finditer(r"^\}\s*// namespace", text, re.M)]
                        + [(m.start(), "kernel", m.group(1)) for m in kernel.finditer(text)])
        stack = []
        for _, kind, name in events:
            if kind == "open":
                stack.append(name)
            elif kind == "close":
                stack.pop()
            else:
                names.append("::".join([ns for ns in stack if ns] + [name]))
    return names


@pytest.mark.parametrize("table,part", [("K2A_PARTS", "proj"), ("K2A_PARTS", "attn"),
                                        ("BWD_PASSES", "dq_pass"), ("BWD_PASSES", "dkv_pass")])
def test_profiler_names_match_kernels(table, part):
    """Each profiler-name pattern by which `chip_smoke.py` splits a kernel's
    time (K2a's projection and attention, the dq and dk/dv passes) matches
    a ``__global__`` function of `csrc/`: a pattern left behind by a renamed
    or deleted kernel would silently time nothing."""
    import chip_smoke

    patterns = getattr(chip_smoke, table)[part]
    globals_ = _global_functions()
    assert "gemm::wgmma_kernel" in globals_ and "attn_bwd::dq_wg_kernel" in globals_
    for pattern in (patterns,) if isinstance(patterns, str) else patterns:
        assert any(pattern in name for name in globals_), (pattern, globals_)


@pytest.mark.parametrize("pattern", ["gemm::", "ln_bwd_kernel", "attn_o_kernel", "attn_bwd_kernel",
                                     "row_wg::attn_wg_kernel", "sum_slabs_kernel"])
def test_sequence_names_match_kernels(pattern):
    """Each profiler-name pattern by which `chip_smoke.py` splits K7's, K7s'
    and K8's launch sequences (`SEQ_KERNELS`: the products, the row kernels,
    both bodies of K7's per-row attention) names a ``__global__`` function
    of `csrc/`."""
    import chip_smoke

    assert pattern in chip_smoke.SEQ_KERNELS
    assert any(pattern in name for name in _global_functions()), pattern
