"""CUDA kernels of the port against their plain versions, at small ragged
shapes, on a CUDA device. Marked ``cuda``: each test skips (in a fixture) where
there is no card. The repository's ``tests/conftest.py`` imports jax, so these
run only where jax is installed too; ``python3 chip_smoke.py`` is the check
that runs on the card at the flagship shapes.
"""

import dataclasses

import pytest
import torch

from chip_smoke import exact_grid

from multimodalpfn_tpu_torch.models import params as tparams
from multimodalpfn_tpu_torch.models.config import ModelConfig
from multimodalpfn_tpu_torch.models.transformer import forward
from multimodalpfn_tpu_torch.ops import flash, fused, item_fused, kernels

# float32 kernels against float32 plain versions: summation order only
F32_TOL = dict(rtol=5e-5, atol=5e-5)
# whole float32 forwards whose op orders differ: the golden parity bound
# (tests/test_forward_parity.py:28)
FORWARD_TOL = dict(rtol=2e-4, atol=2e-5)

# an inference path launches no backward kernel
NO_BACKWARD = {"K7": 0, "K7s": 0, "K8": 0, "K9": 0, "K10": 0, "K11": 0}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0, device):
    return (torch.randn(shape, generator=gen) * scale).to(device)


@pytest.mark.parametrize("t,s", [(13, 37), (31, 5)])
def test_k1_matches_plain(cuda, t, s):
    g = torch.Generator().manual_seed(0)
    x = _rand(g, 2, t, s, 32, device=cuda)
    w_qkv, w_out = _rand(g, 3, 4, 8, 32, scale=0.2, device=cuda), _rand(g, 4, 8, 32, scale=0.2, device=cuda)
    before = kernels.LAUNCHES["K1"]
    got = fused.fused_feature_attention_ln_im(x, w_qkv, w_out)
    assert kernels.LAUNCHES["K1"] == before + 1
    torch.testing.assert_close(got, fused.feature_attention_ln_im_plain(x, w_qkv, w_out), **F32_TOL)


@pytest.mark.parametrize(
    "e,h,d,t",
    [(64, 4, 16, 13), (64, 4, 16, 32), (64, 4, 16, 45), (192, 6, 32, 48), (32, 4, 8, 13)],
)
def test_k1_bf16_matches_plain(cuda, e, h, d, t):
    """bf16 K1 within two bf16 ulps of the largest output of its plain
    version: e = 64, d = 16 and the published e = 192, d = 32 take the wgmma
    body, 64 // t samples a warpgroup's tile (37 samples leave a ragged last
    tile); e = 32, d = 8 the CUDA-core one."""
    g = torch.Generator().manual_seed(6)
    x = _rand(g, 2, t, 37, e, device=cuda).to(torch.bfloat16)
    w_qkv = _rand(g, 3, h, d, e, scale=e**-0.5, device=cuda)
    w_out = _rand(g, h, d, e, scale=(h * d) ** -0.5, device=cuda)
    got = fused.fused_feature_attention_ln_im(x, w_qkv, w_out)
    want = fused.feature_attention_ln_im_plain(x, w_qkv, w_out)
    assert (got.float() - want.float()).abs().max() / want.float().abs().max() <= 2.0**-6


@pytest.mark.parametrize(
    "lead,t,e,h,d,tvc",
    [((2, 37), 31, 32, 4, 8, None), ((3, 11), 48, 64, 4, 16, 40), ((2, 37), 13, 32, 4, 8, 5)],
)
def test_k5_matches_plain(cuda, lead, t, e, h, d, tvc):
    """float32 K5 (the CUDA-core body) on sample-major rows, with and without
    the key mask."""
    g = torch.Generator().manual_seed(8)
    x = _rand(g, *lead, t, e, device=cuda)
    w_qkv, w_out = _rand(g, 3, h, d, e, scale=0.2, device=cuda), _rand(g, h, d, e, scale=0.2, device=cuda)
    before = kernels.LAUNCHES["K5"]
    got = fused.fused_feature_attention_ln(x, w_qkv, w_out, tvc)
    assert kernels.LAUNCHES["K5"] == before + 1
    torch.testing.assert_close(got, fused.feature_attention_ln_plain(x, w_qkv, w_out, tvc), **F32_TOL)


@pytest.mark.parametrize("e,h,d,t,tvc", [(192, 6, 32, 31, None), (192, 6, 32, 48, None),
                                         (64, 4, 16, 31, 20), (64, 4, 16, 48, 33)])
def test_k5_bf16_matches_plain(cuda, e, h, d, t, tvc):
    """bf16 K5 takes the wgmma body (64 // t samples a warpgroup's tile),
    within two bf16 ulps of the largest output."""
    g = torch.Generator().manual_seed(9)
    x = _rand(g, 2, 37, t, e, device=cuda).to(torch.bfloat16)
    w_qkv = _rand(g, 3, h, d, e, scale=e**-0.5, device=cuda)
    w_out = _rand(g, h, d, e, scale=(h * d) ** -0.5, device=cuda)
    got = fused.fused_feature_attention_ln(x, w_qkv, w_out, tvc)
    want = fused.feature_attention_ln_plain(x, w_qkv, w_out, tvc)
    assert (got.float() - want.float()).abs().max() / want.float().abs().max() <= 2.0**-6


def _member_masks(b, t, device):
    """Ragged per-member key masks: member 0 all keys, member 1 only the
    target (the last token), the others a prefix of their feature tokens."""
    m = torch.zeros((b, t), dtype=torch.bool)
    m[:, -1] = True
    m[0] = True
    for i in range(2, b):
        m[i, : max(1, t - 7 * i)] = True
    return m.to(device)


def _check(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32_TOL)
    else:
        assert (got.float() - want.float()).abs().max() / want.float().abs().max() <= 2.0**-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,h,d,t", [(192, 6, 32, 48), (192, 6, 32, 64), (192, 6, 32, 31),
                                     (64, 4, 16, 45), (32, 4, 8, 13)])
def test_k6a_matches_plain(cuda, e, h, d, t, dtype):
    """K6a (item-major, a key mask per member) against its plain version on
    ragged masks, one member keeping only the target key: the wgmma body in
    bf16 at e = 192 and 64, the CUDA-core body otherwise; 37 samples leave a
    ragged last tile."""
    g = torch.Generator().manual_seed(12)
    x = _rand(g, 4, t, 37, e, device=cuda).to(dtype)
    w_qkv = _rand(g, 3, h, d, e, scale=e**-0.5, device=cuda)
    w_out = _rand(g, h, d, e, scale=(h * d) ** -0.5, device=cuda)
    mask = _member_masks(4, t, "cpu")
    before = kernels.LAUNCHES["K6a"]
    got = fused.fused_feature_attention_ln_im(x, w_qkv, w_out, key_mask=mask)
    assert kernels.LAUNCHES["K6a"] == before + 1
    _check(got, fused.feature_attention_ln_im_plain(x, w_qkv, w_out, key_mask=mask), dtype)
    # a mask on the card takes the same path
    torch.testing.assert_close(
        fused.fused_feature_attention_ln_im(x, w_qkv, w_out, key_mask=mask.to(cuda)), got,
        rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,h,d,t", [(192, 6, 32, 48), (192, 6, 32, 64), (64, 4, 16, 31),
                                     (32, 4, 8, 13)])
def test_k6b_matches_plain(cuda, e, h, d, t, dtype):
    """K6b (sample-major rows, the member's mask broadcast over its 37 rows,
    so a tile of the wgmma body straddles two members) against its plain
    version."""
    g = torch.Generator().manual_seed(13)
    x = _rand(g, 4, 37, t, e, device=cuda).to(dtype)
    w_qkv = _rand(g, 3, h, d, e, scale=e**-0.5, device=cuda)
    w_out = _rand(g, h, d, e, scale=(h * d) ** -0.5, device=cuda)
    mask = _member_masks(4, t, "cpu")[:, None, :]
    before = kernels.LAUNCHES["K6b"]
    got = fused.fused_feature_attention_ln(x, w_qkv, w_out, key_mask=mask)
    assert kernels.LAUNCHES["K6b"] == before + 1
    _check(got, fused.feature_attention_ln_plain(x, w_qkv, w_out, key_mask=mask), dtype)


# every token count the feature-attention kernels take that changes how a
# warpgroup's 64-row tile packs samples (64 // t of them)
FEAT_TOKENS = [1, 8, 17, 30, 31, 32, 33, 48, 64]


@pytest.mark.parametrize("s", [37, 301])
@pytest.mark.parametrize("t", FEAT_TOKENS)
@pytest.mark.parametrize("kid", ["K1", "K5", "K5 token_valid", "K6a", "K6b"])
@pytest.mark.parametrize("e,h,d", [(64, 4, 16), (192, 6, 32)])
def test_feat_attn_wgmma_body_matches_plain(cuda, e, h, d, kid, t, s):
    """bf16 K1, K5 (also with token_valid), K6a and K6b on their wgmma body
    (`fused.feat_attn_body`), three members of s samples (ragged tiles of
    64 // t samples; K6b's tiles straddle members), within two bf16 ulps of
    the plain version's largest output; a repeat gives the same bits."""
    g = torch.Generator().manual_seed(t + s)
    sample_major = kid.startswith(("K5", "K6b"))
    x = _rand(g, *((3, s, t, e) if sample_major else (3, t, s, e)), device=cuda).to(torch.bfloat16)
    w_qkv = _rand(g, 3, h, d, e, scale=e**-0.5, device=cuda)
    w_out = _rand(g, h, d, e, scale=(h * d) ** -0.5, device=cuda)
    mask = _member_masks(3, t, "cpu")
    if sample_major:
        tv = max(1, t - 3) if kid == "K5 token_valid" else None
        km = mask[:, None] if kid == "K6b" else None
        args = (x, w_qkv, w_out, tv, km)
        fn, plain = fused.fused_feature_attention_ln, fused.feature_attention_ln_plain
    else:
        args = (x, w_qkv, w_out, mask if kid == "K6a" else None)
        fn, plain = fused.fused_feature_attention_ln_im, fused.feature_attention_ln_im_plain
    assert fused.feat_attn_body(x.dtype, e, h, d) == "wgmma"
    name = kid.split()[0]
    before = kernels.BODY_LAUNCHES[f"{name} wgmma"]
    got = fn(*args)
    again = fn(*args)
    assert kernels.BODY_LAUNCHES[f"{name} wgmma"] == before + 2
    assert torch.equal(got, again)
    want = plain(*args)
    assert bool(torch.isfinite(got.float()).all())
    assert (got.float() - want.float()).abs().max() / want.float().abs().max() <= 2.0**-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Sq,Skv,d", [(3, 37, 45, 16), (2, 130, 200, 32), (4, 200, 1, 32),
                                        (2, 70, 129, 64), (2, 33, 40, 8)])
def test_k4_matches_plain(cuda, G, Sq, Skv, d, dtype):
    """K4 on ragged query and key counts: float32 on the CUDA cores within
    the float32 bound, bf16 (d a multiple of 16: the tensor cores) within two
    bf16 ulps of the largest output; lse in float32 within 1e-4, in bf16
    within 1e-3 (float32 sums of the same bf16 scores, in another order and
    with the weights rescaled per tile)."""
    g = torch.Generator().manual_seed(10)
    q, k, v = (_rand(g, G, n, d, device=cuda).to(dtype) for n in (Sq, Skv, Skv))
    before = kernels.LAUNCHES["K4"]
    o, lse = flash.flash_attention(q, k, v)
    assert kernels.LAUNCHES["K4"] == before + 1
    o_ref, lse_ref = flash.flash_attention_plain(q, k, v)
    assert o.dtype == lse.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(o, o_ref, **F32_TOL)
        torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    else:
        assert (o - o_ref).abs().max() / o_ref.abs().max() <= 2.0**-6
        torch.testing.assert_close(lse, lse_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_multiquery_matches_plain(cuda, dtype):
    """Multiquery: 6 query heads folded head-major into the query axis against
    KV head 0, through `flash_mha`."""
    g = torch.Generator().manual_seed(11)
    B, h, Sq, Skv, d = 3, 6, 50, 77, 32
    q = _rand(g, B, h, Sq, d, device=cuda).to(dtype)
    k, v = (_rand(g, B, 1, Skv, d, device=cuda).to(dtype) for _ in range(2))
    got = flash.flash_mha(q, k, v, kv_head0_only=True)
    want, _ = flash.flash_attention_plain(q.reshape(B, h * Sq, d), k[:, 0], v[:, 0])
    want = want.reshape(B, h, Sq, d)
    bound = 5e-5 if dtype == torch.float32 else 2.0**-6
    assert (got - want).abs().max() / want.abs().max() <= bound


@pytest.mark.parametrize("rows", [1, 33, 100])
def test_k3_matches_plain(cuda, rows):
    g = torch.Generator().manual_seed(1)
    x = _rand(g, rows, 48, device=cuda)
    w1, w2 = _rand(g, 48, 200, scale=0.1, device=cuda), _rand(g, 200, 48, scale=0.1, device=cuda)
    torch.testing.assert_close(fused.fused_mlp_ln(x, w1, w2), fused.mlp_ln_plain(x, w1, w2), **F32_TOL)


@pytest.mark.parametrize("S,sep", [(70, 48), (48, 48), (130, 1)])
def test_k2_matches_plain(cuda, S, sep):
    g = torch.Generator().manual_seed(2)
    x3 = _rand(g, 3, S, 16, device=cuda)
    w_qkv, w_out = _rand(g, 3, 2, 8, 16, scale=0.2, device=cuda), _rand(g, 2, 8, 16, scale=0.2, device=cuda)
    o, lse = item_fused.item_attention_core(x3, w_qkv, sep)
    o_ref, lse_ref = item_fused.item_attention_core_plain(x3, w_qkv, sep)
    torch.testing.assert_close(o, o_ref, **F32_TOL)
    torch.testing.assert_close(lse, lse_ref, **F32_TOL)
    torch.testing.assert_close(
        item_fused.item_epilogue_ln(x3, o, w_out),
        item_fused.item_epilogue_ln_plain(x3, o, w_out),
        **F32_TOL,
    )


@pytest.mark.parametrize("d,e", [(16, 32), (8, 36)])
def test_k2a_bf16_matches_plain(cuda, d, e):
    """bf16 K2a within two bf16 ulps of the largest output of its plain
    version: d = 16, e = 32 takes the tensor-core projection and attention,
    d = 8, e = 36 the CUDA-core ones."""
    g = torch.Generator().manual_seed(3)
    x3 = _rand(g, 3, 150, e, device=cuda).to(torch.bfloat16)
    w_qkv = _rand(g, 3, 2, d, e, scale=0.2, device=cuda)
    o, lse = item_fused.item_attention_core(x3, w_qkv, 100)
    o_ref, lse_ref = item_fused.item_attention_core_plain(x3, w_qkv, 100)
    err = (o.float() - o_ref.float()).abs().max() / o_ref.float().abs().max()
    assert err <= 2.0**-6
    # lse sums float32 exponentials of the same bf16 scores
    torch.testing.assert_close(lse, lse_ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("e,hd", [(64, 96), (48, 40), (96, 96), (48, 48)])
def test_k2b_bf16_matches_plain(cuda, e, hd):
    """bf16 K2b within two bf16 ulps of the largest output: e = 64, h·d = 96
    (with a ragged last chunk of o) and e = 96 take the mma.sync body, e =
    48 the CUDA-core one."""
    _check_k2b_body(cuda, (2, 77), e, hd, "cuda_cores" if e == 48 else "mma_sync", seed=5)


def _check_k2b_body(device, lead, e, hd, body, seed=5):
    """bf16 K2b at x ``(*lead, e)``, o ``(*lead, hd)`` runs ``body``
    (`item_fused.item_epilogue_body`), is within two bf16 ulps of the
    largest output of its plain version, and a repeat gives the same bits."""
    g = torch.Generator().manual_seed(seed)
    x3 = _rand(g, *lead, e, device=device).to(torch.bfloat16)
    o = _rand(g, *lead, hd, device=device).to(torch.bfloat16)
    w_out = _rand(g, hd, e, scale=hd**-0.5, device=device)
    kernels.reset_launches()
    got, again = item_fused.item_epilogue_ln(x3, o, w_out), item_fused.item_epilogue_ln(x3, o, w_out)
    assert kernels.BODY_LAUNCHES[f"K2b {body}"] == kernels.LAUNCHES["K2b"] == 2
    want = item_fused.item_epilogue_ln_plain(x3, o, w_out)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max() / want.float().abs().max() <= 2.0**-6
    assert torch.equal(got, again)


# row counts around the 64-row unit, a block's two units and the 132-block
# grid (units split 2 a block until every SM has one)
K2B_ROWS = [1, 77, 127, 129, 128 * 132 + 1]


@pytest.mark.parametrize("rows", K2B_ROWS)
@pytest.mark.parametrize("e,hd", [(64, 64), (128, 128), (192, 192), (192, 64)])
def test_k2b_wgmma_body_matches_plain(cuda, e, hd, rows):
    _check_k2b_body(cuda, (rows,), e, hd, "wgmma")


@pytest.mark.parametrize("lead", [(124, 2350), (30, 1838)])
def test_k2b_wgmma_body_at_served_shapes(cuda, lead):
    """The fit_preprocessors activation (4 members × 31 tokens, 2350 rows)
    and the fine-tune episode (30 tokens, 1838 rows)."""
    _check_k2b_body(cuda, lead, 192, 192, "wgmma")


@pytest.mark.parametrize("d,e", [(32, 192), (16, 32), (8, 96)])
def test_k2a_bf16_qkv_equals_k9s(cuda, d, e):
    """bf16 K2a's projection is the product through which K9 recomputes qkv
    (`gemm_tile.cuh`): on the same operands the two give the same bits, and
    K2a stays within two bf16 ulps of its plain version."""
    g = torch.Generator().manual_seed(9)
    G, S, sep, h = 3, 150, 100, 2
    x3 = _rand(g, G, S, e, device=cuda).to(torch.bfloat16)
    w_qkv = _rand(g, 3, h, d, e, scale=e**-0.5, device=cuda)
    qkv = item_fused._project_qkv(x3, w_qkv)
    o, lse = item_fused.item_attention_core(x3, w_qkv, sep)
    do = _rand(g, G, S, h * d, device=cuda).to(torch.bfloat16)
    delta, du = _rand(g, G, h, S, device=cuda), _rand(g, G, S, e, device=cuda).to(torch.bfloat16)
    *_, qkv9 = item_fused._launch_item_attention_bwd(x3, w_qkv, do, delta, lse, sep, du)
    assert torch.equal(qkv.reshape(G * S, -1), qkv9)
    o_ref, _ = item_fused.item_attention_core_plain(x3, w_qkv, sep)
    assert (o.float() - o_ref.float()).abs().max() / o_ref.float().abs().max() <= 2.0**-6


@pytest.mark.parametrize("e,nhid", [(64, 128), (48, 200)])
def test_k3_bf16_matches_plain(cuda, e, nhid):
    """bf16 K3 (e = 64, nhid = 128 takes the wgmma body, the other shape the
    CUDA-core one) within two bf16 ulps of the largest output."""
    g = torch.Generator().manual_seed(4)
    x = _rand(g, 77, e, device=cuda).to(torch.bfloat16)
    w1, w2 = _rand(g, e, nhid, scale=e**-0.5, device=cuda), _rand(g, nhid, e, scale=nhid**-0.5, device=cuda)
    got, want = fused.fused_mlp_ln(x, w1, w2), fused.mlp_ln_plain(x, w1, w2)
    assert (got.float() - want.float()).abs().max() / want.float().abs().max() <= 2.0**-6


def _check_k3_body(device, lead, e, nhid, body, seed=4):
    """bf16 K3 at x ``(*lead, e)`` runs ``body`` (`fused.mlp_ln_body`), is
    within two bf16 ulps of the largest output of its plain version, and a
    repeat gives the same bits."""
    g = torch.Generator().manual_seed(seed)
    x = _rand(g, *lead, e, device=device).to(torch.bfloat16)
    w1, w2 = _rand(g, e, nhid, scale=e**-0.5, device=device), _rand(g, nhid, e, scale=nhid**-0.5, device=device)
    kernels.reset_launches()
    got, again = fused.fused_mlp_ln(x, w1, w2), fused.fused_mlp_ln(x, w1, w2)
    assert kernels.BODY_LAUNCHES[f"K3 {body}"] == kernels.LAUNCHES["K3"] == 2
    want = fused.mlp_ln_plain(x, w1, w2)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max() / want.float().abs().max() <= 2.0**-6
    assert torch.equal(got, again)


# row counts around the 128-row tile and the 132-block grid, and the
# fit_preprocessors activation's 291,400 rows
K3_ROWS = [1, 63, 127, 128, 129, 128 * 132 + 1, 4 * 31 * 2350]


@pytest.mark.parametrize("rows", K3_ROWS)
@pytest.mark.parametrize("nhid", [128, 768])
@pytest.mark.parametrize("e", [64, 128, 192])
def test_k3_wgmma_body_matches_plain(cuda, e, nhid, rows):
    _check_k3_body(cuda, (rows,), e, nhid, "wgmma")


@pytest.mark.parametrize("lead", [(4, 31, 2350), (4 * 1838, 48)])
def test_k3_wgmma_body_at_served_shapes(cuda, lead):
    """The fit_preprocessors activation and the KV-cache prime's merged group."""
    _check_k3_body(cuda, lead, 192, 768, "wgmma")


@pytest.mark.parametrize("rows", [1, 77, 129])
@pytest.mark.parametrize("e", [32, 96, 160])
def test_k3_mma_sync_body_matches_plain(cuda, e, rows):
    _check_k3_body(cuda, (rows,), e, 128, "mma_sync")


def _forward_case(device, n_features, S=40, sep=30):
    """A 2-layer float32 model (e = 64, h = 4) with every output projection
    filled in, and inputs of ``n_features`` tabular features."""
    cfg = ModelConfig(emsize=64, nhead=4, nhid_factor=2, nlayers=2, n_out=5)
    g = torch.Generator().manual_seed(7)
    params = tparams.init_params(g, cfg)
    layers = params["layers"]
    for w in (layers["attn_feat"]["w_out"], layers["attn_item"]["w_out"], layers["mlp"]["w2"]):
        w.copy_(torch.randn(w.shape, generator=g) * w.shape[-2] ** -0.5)
    x = torch.randn((2, S, n_features), generator=g)
    y = torch.randint(0, 5, (2, sep), generator=g).float()
    return tparams.params_to(params, device), cfg, x.to(device), y.to(device), sep


def test_forward_many_tokens_runs_item_and_mlp_kernels(cuda):
    """With more feature tokens (71) than K1 takes, the kernel path runs the
    sample-major layer: plain feature attention (as in the JAX package), then
    K2a + K2b and K3 in every layer. Its logits match the plain path's."""
    params, cfg, x, y, sep = _forward_case(cuda, n_features=70)
    before = dict(kernels.LAUNCHES)
    got = forward(params, dataclasses.replace(cfg, fused_ops=True, use_flash=True), x, y,
                  single_eval_pos=sep)
    ran = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert ran == {"K1": 0, "K2a": cfg.nlayers, "K2b": cfg.nlayers, "K3": cfg.nlayers, "K4": 0, "K5": 0,
                   "K6a": 0, "K6b": 0} | NO_BACKWARD
    torch.testing.assert_close(got, forward(params, cfg, x, y, single_eval_pos=sep), **FORWARD_TOL)


@pytest.mark.parametrize(
    "cfg_kw", [dict(multiquery_item_attention_for_test_set=False), dict(fused_item=False)]
)
def test_forward_refused_item_attention_runs_k4(cuda, cfg_kw):
    """Item attention that the K2 gate refuses (no multiquery test block, or
    ``fused_item`` off) runs K4 for both blocks of every layer, as the JAX
    package runs its flash kernel there; the logits match the plain path's."""
    params, cfg, x, y, sep = _forward_case(cuda, n_features=5)
    run = dataclasses.replace(cfg, fused_ops=True, use_flash=True, **cfg_kw)
    before = dict(kernels.LAUNCHES)
    got = forward(params, run, x, y, single_eval_pos=sep)
    ran = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert ran == {"K1": cfg.nlayers, "K2a": 0, "K2b": 0, "K3": cfg.nlayers, "K4": 2 * cfg.nlayers,
                   "K5": 0, "K6a": 0, "K6b": 0} | NO_BACKWARD
    plain = forward(params, dataclasses.replace(cfg, **cfg_kw), x, y, single_eval_pos=sep)
    torch.testing.assert_close(got, plain, **FORWARD_TOL)


def test_cached_serving_runs_k4_k5_k3(cuda):
    """``fit_with_cache`` on the card: prime and each predict launch K5, K4
    and K3 once per layer, and no item-major kernel; float32 answers match
    the cached plain path's."""
    from multimodalpfn_tpu_torch import TabPFNClassifier
    from multimodalpfn_tpu_torch.datasets.synthetic import toy_classification
    from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig

    X, y = toy_classification(n=90, n_classes=3, seed=4)
    clf = TabPFNClassifier(
        model_path="random:0", n_estimators=2, fit_mode="fit_with_cache", device="cuda",
        inference_precision="float32",
        inference_config={"PREPROCESS_TRANSFORMS": [
            PreprocessorConfig("none", categorical_name="numeric", subsample_features=-1)]},
    )
    kernels.reset_launches()
    clf.fit(X[:60], y[:60])
    groups = len(clf.executor_.caches)
    p_kernel = clf.predict_proba(X[60:])
    layers = clf.config_.nlayers
    assert kernels.LAUNCHES == {"K1": 0, "K2a": 0, "K2b": 0, "K3": 2 * layers * groups,
                                "K4": 2 * layers * groups, "K5": 2 * layers * groups,
                                "K6a": 0, "K6b": 0} | NO_BACKWARD
    clf.executor_.use_kernels = False  # primes again, on the plain path
    p_plain = clf.predict_proba(X[60:])
    assert abs(p_kernel - p_plain).max() <= 1e-4


def test_forced_merge_runs_k6a_and_k6b(cuda, monkeypatch):
    """Members of two widths forced into one padded group: the full forward
    launches K6a (and no K1) in every layer, the cached prime and predict K6b
    (and no K5); float32 merged answers equal the split ones."""
    import numpy as np

    import multimodalpfn_tpu_torch.estimator.inference as inf
    from multimodalpfn_tpu_torch import TabPFNClassifier
    from multimodalpfn_tpu_torch.datasets.synthetic import toy_classification
    from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig

    X, y = toy_classification(n=90, n_features=6, n_classes=3, seed=5)
    X = np.concatenate([X, X[:, :3] ** 2], axis=1)
    transforms = [PreprocessorConfig("none", categorical_name="numeric"),
                  PreprocessorConfig("none", categorical_name="numeric", subsample_features=0.5)]
    answers = {}
    for fit_mode in ("fit_preprocessors", "fit_with_cache"):
        for force in (True, False):
            monkeypatch.setattr(inf, "_FORCE_MERGE", force)
            clf = TabPFNClassifier(model_path="random:0", n_estimators=2, fit_mode=fit_mode,
                                   device="cuda", inference_precision="float32",
                                   inference_config={"PREPROCESS_TRANSFORMS": transforms})
            kernels.reset_launches()
            clf.fit(X[:60], y[:60])
            answers[fit_mode, force] = clf.predict_proba(X[60:])
            layers = clf.config_.nlayers
            if force and fit_mode == "fit_preprocessors":
                assert kernels.LAUNCHES["K6a"] == layers and kernels.LAUNCHES["K1"] == 0
            if force and fit_mode == "fit_with_cache":
                assert kernels.LAUNCHES["K6b"] == 2 * layers and kernels.LAUNCHES["K5"] == 0
        assert abs(answers[fit_mode, True] - answers[fit_mode, False]).max() <= 1e-5


# ---- backward kernels (fine-tuning) -----------------------------------------


def _bwd_cases(gen, device, dtype, b, t, S, sep, e, h, d, nhid):
    """The backward kernels' operands at one shape: K9's do, delta and du
    come from the plain item forward and K10's plain version."""
    x, g = _rand(gen, b, t, S, e, device=device), _rand(gen, b, t, S, e, device=device)
    w_qkv = _rand(gen, 3, h, d, e, scale=e**-0.5, device=device)
    w_out = _rand(gen, h, d, e, scale=(h * d) ** -0.5, device=device)
    w1 = _rand(gen, e, nhid, scale=e**-0.5, device=device)
    w2 = _rand(gen, nhid, e, scale=nhid**-0.5, device=device)
    x, g = x.to(dtype), g.to(dtype)
    x3, g3 = x.reshape(b * t, S, e), g.reshape(b * t, S, e)
    o, lse = item_fused.item_attention_core_plain(x3, w_qkv, sep)
    du, do, delta, _ = item_fused.item_epilogue_bwd_plain(x3, o, w_out, g3)
    return {
        "K7": (fused.feature_attention_ln_im_bwd, fused.feature_attention_ln_im_bwd_plain,
               (x, w_qkv, w_out, g)),
        "K8": (fused.mlp_ln_bwd, fused.mlp_ln_bwd_plain, (x, w1, w2, g)),
        "K10": (item_fused.item_epilogue_bwd, item_fused.item_epilogue_bwd_plain, (x3, o, w_out, g3)),
        "K9": (item_fused.item_attention_bwd, item_fused.item_attention_bwd_plain,
               (x3, w_qkv, do, delta, lse, sep, du)),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,t,S,sep,e,h,d,nhid",
    [(1, 5, 37, 21, 48, 3, 16, 96),     # ragged rows, tokens and regions
     (2, 7, 70, 48, 64, 2, 32, 128),    # two members
     (1, 3, 9, 1, 32, 4, 8, 64),        # one train row, d = 8
     (1, 4, 40, 40, 64, 2, 32, 128),    # no test rows
     (1, 30, 150, 131, 192, 6, 32, 768),   # the flagship's widths and tokens
     (1, 30, 70, 51, 192, 6, 32, 768),     # 2100 rows: a weight-gradient chunk edge at 2048
     (1, 6, 45, 40, 128, 4, 32, 512),      # e = 128: K8's row pass at its middle width
     (1, 2, 45, 40, 192, 6, 32, 768)],     # 90 rows, fewer than one of K8's 128-row tiles
)
def test_backward_kernels_match_plain(cuda, dtype, b, t, S, sep, e, h, d, nhid):
    """K7, K8, K10 and K9 against their plain versions, every output
    relative to its own largest magnitude (float32 5e-5, bf16 two bf16 ulps);
    a second run on the same inputs gives the same bits (the weight gradients
    are summed in a fixed order, without atomics)."""
    gen = torch.Generator().manual_seed(14)
    bound = 5e-5 if dtype == torch.float32 else 2.0**-6
    for kid, (kern, plain, args) in _bwd_cases(gen, cuda, dtype, b, t, S, sep, e, h, d, nhid).items():
        before = kernels.LAUNCHES[kid]
        got, again = kern(*args), kern(*args)
        assert kernels.LAUNCHES[kid] == before + 2
        for i, (a, c, w) in enumerate(zip(got, again, plain(*args))):
            assert a.dtype == w.dtype and a.shape == w.shape, (kid, i)
            assert torch.equal(a, c), f"{kid} output {i} differs between runs"
            assert torch.isfinite(a.float()).all(), (kid, i)
            rel = (a.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30)
            assert rel <= bound, f"{kid} output {i}: rel err {float(rel):.3e}"


def test_k8_row_pass_and_the_f32_sequence(cuda):
    """bf16 K8 at e = 192 runs its row pass (`fused.mlp_bwd_body`) and no
    other body; float32 K8 runs the sequence, whose outputs keep the bits
    recorded in `chip_smoke.PARENT_F32_SHA256` (`chip_smoke.f32_fingerprints`)."""
    import chip_smoke

    gen = torch.Generator().manual_seed(19)
    e, nhid = 192, 768
    x, g = (_rand(gen, 1, 3, 70, e, device=cuda) for _ in range(2))
    w1, w2 = _rand(gen, e, nhid, scale=e**-0.5, device=cuda), _rand(gen, nhid, e, scale=nhid**-0.5, device=cuda)
    assert fused.mlp_bwd_body(torch.bfloat16, e, nhid) == "wgmma"
    assert fused.mlp_bwd_body(torch.float32, e, nhid) == "sequence"
    before = {k: kernels.BODY_LAUNCHES[f"K8 {k}"] for k in ("wgmma", "sequence")}
    fused.mlp_ln_bwd(x.to(torch.bfloat16), w1, w2, g.to(torch.bfloat16))
    assert kernels.BODY_LAUNCHES["K8 wgmma"] == before["wgmma"] + 1
    assert kernels.BODY_LAUNCHES["K8 sequence"] == before["sequence"]
    fused.mlp_ln_bwd(x, w1, w2, g)
    assert kernels.BODY_LAUNCHES["K8 sequence"] == before["sequence"] + 1
    assert chip_smoke.f32_fingerprints(cuda)["K8 f32"] == chip_smoke.PARENT_F32_SHA256["K8 f32"]


@pytest.mark.parametrize("e", [64, 128, 192])
@pytest.mark.parametrize("h,d", [(2, 32), (4, 32), (6, 32), (8, 32), (4, 48), (8, 8), (2, 128)])
@pytest.mark.parametrize("G,S", [(1, 64), (3, 37), (2, 150)])
def test_k10_row_pass_matches_plain(cuda, e, h, d, G, S):
    """bf16 K10 on its row pass (`item_fused.item_epilogue_bwd_body`) at
    e = 64, 128, 192 and h·d = 64 ... 256 (heads of d = 48 and 128 across
    its 64-column chunks), on one whole unit of rows and on ragged groups
    that its 64-row units straddle: du, do, delta and dW_out within 2**-6
    of their own largest magnitude of the plain version; a repeat gives the
    same bits; every launch counted on the row pass."""
    gen = torch.Generator().manual_seed(100 * e + 10 * h + d + G * S)
    hd = h * d
    x3, g3 = (_rand(gen, G, S, e, device=cuda).to(torch.bfloat16) for _ in range(2))
    o = _rand(gen, G, S, hd, device=cuda).to(torch.bfloat16)
    w_out = _rand(gen, h, d, e, scale=hd**-0.5, device=cuda)
    assert item_fused.item_epilogue_bwd_body(torch.bfloat16, e, hd, d) == "wgmma"
    before = kernels.BODY_LAUNCHES["K10 wgmma"]
    got, again = item_fused.item_epilogue_bwd(x3, o, w_out, g3), item_fused.item_epilogue_bwd(x3, o, w_out, g3)
    assert kernels.BODY_LAUNCHES["K10 wgmma"] == before + 2
    for i, (a, c, w) in enumerate(zip(got, again, item_fused.item_epilogue_bwd_plain(x3, o, w_out, g3))):
        assert a.dtype == w.dtype and a.shape == w.shape, i
        assert torch.equal(a, c), f"output {i} differs between runs"
        rel = (a.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30)
        assert rel <= 2.0**-6, f"output {i}: rel err {float(rel):.3e}"


def test_k10_row_pass_and_the_f32_sequence(cuda):
    """bf16 K10 at the flagship's widths runs its row pass and no other
    body; float32 K10 runs the sequence, whose outputs keep the bits
    recorded in `chip_smoke.PARENT_F32_SHA256` (`chip_smoke.f32_fingerprints`)."""
    import chip_smoke

    gen = torch.Generator().manual_seed(20)
    e, h, d = 192, 6, 32
    x3, g3, o = (_rand(gen, 3, 70, w, device=cuda) for w in (e, e, h * d))
    w_out = _rand(gen, h, d, e, scale=(h * d) ** -0.5, device=cuda)
    before = {k: kernels.BODY_LAUNCHES[f"K10 {k}"] for k in ("wgmma", "sequence")}
    item_fused.item_epilogue_bwd(x3.to(torch.bfloat16), o.to(torch.bfloat16), w_out, g3.to(torch.bfloat16))
    assert kernels.BODY_LAUNCHES["K10 wgmma"] == before["wgmma"] + 1
    assert kernels.BODY_LAUNCHES["K10 sequence"] == before["sequence"]
    item_fused.item_epilogue_bwd(x3, o, w_out, g3)
    assert kernels.BODY_LAUNCHES["K10 sequence"] == before["sequence"] + 1
    assert chip_smoke.f32_fingerprints(cuda)["K10 f32"] == chip_smoke.PARENT_F32_SHA256["K10 f32"]


# token counts that change how a 64-row tile of K7's per-row attention packs
# whole samples (64 // t of them): one key, two, ragged rows, the episode's
# 30, a tile of one sample from 33 on, no idle row at 64
K7_TOKENS = [1, 2, 7, 21, 30, 31, 32, 33, 48, 63, 64]


@pytest.mark.parametrize("s", [37, 150])
@pytest.mark.parametrize("t", K7_TOKENS)
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("kid", ["K7", "K7s"])
def test_k7_attention_wgmma_matches_plain(cuda, kid, d, t, s):
    """bf16 K7 (item-major) and K7s (sample-major) with their per-row
    attention on the wgmma body (`fused.feat_attn_bwd_body`), two members of
    s samples (the last tile of 64 // t samples ragged), against the plain
    backward: every output within 2**-6 of its own largest magnitude; a
    repeat gives the same bits; every launch counted on the wgmma body."""
    g = torch.Generator().manual_seed(1000 * d + 10 * t + s)
    h, e = 2, 48
    lead = (2, s, t) if kid == "K7s" else (2, t, s)
    x, gr = (_rand(g, *lead, e, device=cuda).to(torch.bfloat16) for _ in range(2))
    w_qkv = _rand(g, 3, h, d, e, scale=e**-0.5, device=cuda)
    w_out = _rand(g, h, d, e, scale=(h * d) ** -0.5, device=cuda)
    kern, plain = ((fused.feature_attention_ln_bwd, fused.feature_attention_ln_bwd_plain) if kid == "K7s"
                   else (fused.feature_attention_ln_im_bwd, fused.feature_attention_ln_im_bwd_plain))
    assert fused.feat_attn_bwd_body(x.dtype, d) == "wgmma"
    before = {k: kernels.BODY_LAUNCHES[f"{kid} {k}"] for k in ("wgmma", "cuda_cores")}
    got, again = kern(x, w_qkv, w_out, gr), kern(x, w_qkv, w_out, gr)
    assert kernels.BODY_LAUNCHES[f"{kid} wgmma"] == before["wgmma"] + 2
    assert kernels.BODY_LAUNCHES[f"{kid} cuda_cores"] == before["cuda_cores"]
    for i, (a, c, w) in enumerate(zip(got, again, plain(x, w_qkv, w_out, gr))):
        assert a.dtype == w.dtype and a.shape == w.shape, i
        assert torch.equal(a, c), f"output {i} differs between runs"
        assert torch.isfinite(a.float()).all(), i
        rel = (a.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30)
        assert rel <= 2.0**-6, f"output {i}: rel err {float(rel):.3e}"


@pytest.mark.parametrize("k_chunk", [0, 2048])
@pytest.mark.parametrize("a_t,b_t", [(False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("K", [16, 192, 576, 2047, 2048, 2049, 4097])
@pytest.mark.parametrize("N", [8, 192, 576, 768])
@pytest.mark.parametrize("M", [1, 63, 64, 65, 129, 192, 200, 776, 2049])
def test_gemm_bf16_matches_matmul(cuda, M, N, K, a_t, b_t, k_chunk):
    """The bf16 product tile of K7-K10 alone (`kernels.gemm_bf16`), every
    storage order, ragged against its 128 × 192 tiles and 64-deep k-tiles,
    with and without chunks of 2048: ``torch.matmul`` of the same bf16
    operands in float32 (TF32 off), to 1e-5 of the largest output (summation
    order only); a repeat gives the same bits. Odd K (a_t False or b_t True)
    and M off a multiple of 8 (a_t True) take the CUDA-core body; M = 64,
    192, 200 and 776 give the transposed A (the weight gradients' operand)
    one warpgroup, both, several 128-row tiles and a partial one."""
    gen = torch.Generator(device=cuda).manual_seed(M * 7919 + N * 31 + K)
    a = torch.randn((K, M) if a_t else (M, K), generator=gen, device=cuda).to(torch.bfloat16)
    b = torch.randn((N, K) if b_t else (K, N), generator=gen, device=cuda).to(torch.bfloat16)
    got, again = kernels.gemm_bf16(a, b, a_t, b_t, k_chunk), kernels.gemm_bf16(a, b, a_t, b_t, k_chunk)
    want = torch.matmul((a.t() if a_t else a).float(), (b.t() if b_t else b).float())
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max().clamp_min(1e-30)


def test_gemm_bf16_refuses_a_chunk_off_the_k_tile(cuda):
    """A chunk of a tensor-core product that is not a whole number of
    64-deep k-tiles would make a TMA box straddle two chunks: refused."""
    a = torch.ones((128, 256), device=cuda, dtype=torch.bfloat16)
    b = torch.ones((256, 192), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="not supported"):
        kernels.gemm_bf16(a, b, k_chunk=100)
    assert torch.equal(kernels.gemm_bf16(a, b, k_chunk=128), kernels.gemm_bf16_plain(a, b))


def test_inference_only_kernels_raise_under_autograd(cuda):
    """K5 with ``token_valid_count``, K6a and K6b have no backward kernel: on
    the card their wrappers refuse inputs that require grad, and run under
    no_grad. K4 and the unmasked K5 have one (K11, K7s) and return
    gradients."""
    gen = torch.Generator().manual_seed(15)
    x = _rand(gen, 2, 5, 7, 32, device=cuda).requires_grad_(True)
    w_qkv, w_out = _rand(gen, 3, 4, 8, 32, device=cuda), _rand(gen, 4, 8, 32, device=cuda)
    mask = torch.ones((2, 7), dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="K5"):
        fused.fused_feature_attention_ln(x, w_qkv, w_out, token_valid_count=6)
    with pytest.raises(NotImplementedError, match="K6b"):
        fused.fused_feature_attention_ln(x, w_qkv, w_out, key_mask=mask[:, None])
    xi = x.detach().transpose(1, 2).contiguous().requires_grad_(True)  # (b, t, s, e)
    with pytest.raises(NotImplementedError, match="K6a"):
        fused.fused_feature_attention_ln_im(xi, w_qkv, w_out, key_mask=mask)
    with torch.no_grad():
        fused.fused_feature_attention_ln(x, w_qkv, w_out, token_valid_count=6)
        fused.fused_feature_attention_ln_im(xi, w_qkv, w_out, key_mask=mask)
    before = dict(kernels.LAUNCHES)
    q = _rand(gen, 2, 9, 16, device=cuda).requires_grad_(True)
    o, lse = flash.flash_attention(q, q, q)
    (dq,) = torch.autograd.grad(o, q, torch.ones_like(o))
    assert dq.shape == q.shape and torch.isfinite(dq).all() and not lse.requires_grad
    out = fused.fused_feature_attention_ln(x, w_qkv, w_out)
    (dx,) = torch.autograd.grad(out, x, torch.ones_like(out))
    assert dx.shape == x.shape and torch.isfinite(dx).all()
    ran = {k: kernels.LAUNCHES[k] - before[k] for k in ("K4", "K5", "K7s", "K11")}
    assert ran == {"K4": 1, "K5": 1, "K7s": 1, "K11": 1}


# K11 at ragged shapes: Sq and Skv off the 64-row tiles, Skv below one tile,
# the folded multiquery block (h·Sq queries against one KV head), d 8 to 64
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Sq,Skv,d", [(3, 70, 90, 32), (2, 183, 131, 16), (4, 5, 37, 8),
                                        (2, 6 * 61, 129, 32), (1, 130, 200, 64)])
def test_k11_matches_plain(cuda, dtype, G, Sq, Skv, d):
    """K11 against its plain version from K4's saved o and lse (float32 5e-5,
    bf16 two bf16 ulps, each output relative to its own largest magnitude),
    the same bits on a second run."""
    gen = torch.Generator().manual_seed(G * 1000 + Sq + Skv + d)
    q = _rand(gen, G, Sq, d, device=cuda).to(dtype)
    k, v = (_rand(gen, G, Skv, d, device=cuda).to(dtype) for _ in range(2))
    o, lse = flash.flash_attention(q, k, v)
    do = _rand(gen, G, Sq, d, device=cuda)
    bound = 5e-5 if dtype == torch.float32 else 2.0**-6
    before = kernels.LAUNCHES["K11"]
    got, again = flash.flash_attention_bwd(q, k, v, o, lse, do), flash.flash_attention_bwd(q, k, v, o, lse, do)
    assert kernels.LAUNCHES["K11"] == before + 2
    for name, a, c, w in zip(("dq", "dk", "dv"), got, again,
                             flash.flash_attention_bwd_plain(q, k, v, o, lse, do)):
        assert a.dtype == w.dtype == dtype and a.shape == w.shape, name
        assert torch.equal(a, c), f"{name} differs between runs"
        rel = (a.float() - w.float()).abs().max() / w.float().abs().max()
        assert rel <= bound, f"{name}: rel err {float(rel):.3e}"


# The bf16 passes of K9 and K11 (TMA ring, wgmma; csrc/attn_bwd.cuh) at
# every ragged length around the 64-row tiles and 128-row blocks, the
# fine-tune's lengths (183 test rows, 1098 folded, 1655 train) and one row
RAGGED = [1, 63, 64, 65, 183, 1098, 1655]


def _k11_case(device, dtype, G, Sq, Skv, d):
    gen = torch.Generator().manual_seed(G * 1000 + Sq + 7 * Skv + d)
    q = _rand(gen, G, Sq, d, device=device).to(dtype)
    k, v = (_rand(gen, G, Skv, d, device=device).to(dtype) for _ in range(2))
    o, lse = flash.flash_attention(q, k, v)
    return q, k, v, o, lse, _rand(gen, G, Sq, d, device=device)


def _check_k11(args, dtype):
    bound = 5e-5 if dtype == torch.float32 else 2.0**-6
    before = kernels.LAUNCHES["K11"]
    got, again = flash.flash_attention_bwd(*args), flash.flash_attention_bwd(*args)
    assert kernels.LAUNCHES["K11"] == before + 2
    for name, a, c, w in zip(("dq", "dk", "dv"), got, again, flash.flash_attention_bwd_plain(*args)):
        assert a.dtype == w.dtype == dtype and a.shape == w.shape, name
        assert torch.equal(a, c), f"{name} differs between runs"
        assert torch.isfinite(a.float()).all(), name
        rel = (a.float() - w.float()).abs().max() / w.float().abs().max()
        assert rel <= bound, f"{name}: rel err {float(rel):.3e}"


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("Skv", RAGGED)
@pytest.mark.parametrize("Sq", RAGGED)
def test_k11_bf16_ragged_matches_plain(cuda, Sq, Skv, d):
    """bf16 K11 within two bf16 ulps of its plain version, bit-equal on a
    repeat, at every pair of ragged lengths and every d the wgmma passes
    serve."""
    _check_k11(_k11_case(cuda, torch.bfloat16, 2, Sq, Skv, d), torch.bfloat16)


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("h,Sq", [(6, 183), (6, 61), (2, 1)])
def test_k11_bf16_folded_multiquery_matches_plain(cuda, h, Sq, d):
    """The folded multiquery block: h heads' Sq query rows each against one
    KV head of the 1655 train rows, so every key's dk and dv sum over all
    h·Sq query rows (the GQA reduction)."""
    _check_k11(_k11_case(cuda, torch.bfloat16, 3, h * Sq, 1655, d), torch.bfloat16)


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("S,sep", [(200, 1), (200, 128), (200, 199), (300, 64), (1838, 1655)])
def test_k9_bf16_regions_match_plain(cuda, S, sep, d):
    """bf16 K9 (dx and dW_qkv) within two bf16 ulps of its plain version and
    bit-equal on a repeat, with `sep` at one train row, at a multiple of 64
    (a query block ending exactly at the region's end), at S − 1 (one test
    row per head) and at the flagship's split."""
    h, e = 6, 96 if d < 64 else 128
    gen = torch.Generator().manual_seed(S + sep + d)
    x3 = _rand(gen, 2, S, e, device=cuda).to(torch.bfloat16)
    g3 = _rand(gen, 2, S, e, device=cuda).to(torch.bfloat16)
    w_qkv = _rand(gen, 3, h, d, e, scale=e**-0.5, device=cuda)
    w_out = _rand(gen, h, d, e, scale=(h * d) ** -0.5, device=cuda)
    o, lse = item_fused.item_attention_core_plain(x3, w_qkv, sep)
    du, do, delta, _ = item_fused.item_epilogue_bwd_plain(x3, o, w_out, g3)
    args = (x3, w_qkv, do, delta, lse, sep, du)
    before = kernels.LAUNCHES["K9"]
    got, again = item_fused.item_attention_bwd(*args), item_fused.item_attention_bwd(*args)
    assert kernels.LAUNCHES["K9"] == before + 2
    for i, (a, c, w) in enumerate(zip(got, again, item_fused.item_attention_bwd_plain(*args))):
        assert a.dtype == w.dtype and a.shape == w.shape, i
        assert torch.equal(a, c), f"output {i} differs between runs"
        rel = (a.float() - w.float()).abs().max() / w.float().abs().max()
        assert rel <= 2.0**-6, f"output {i}: rel err {float(rel):.3e}"


# The bf16 forward of K4 and K2a (TMA ring, wgmma; csrc/attn_tile.cuh) at
# every ragged length around its 64-key tiles and 128-row blocks and at the
# flash fine-tune's 1655 train rows. lse within 1e-4 abs: K9 and K11
# recompute every weight from it.
FWD_RAGGED = [1, 63, 64, 65, 127, 128, 129, 1655]


def _check_fwd(kernel_id, fn, plain, args):
    before = kernels.LAUNCHES[kernel_id]
    (o, lse), (o2, lse2) = fn(*args), fn(*args)
    assert kernels.LAUNCHES[kernel_id] == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2), "differs between runs"
    o_ref, lse_ref = plain(*args)
    assert o.dtype == o_ref.dtype and o.shape == o_ref.shape and lse.shape == lse_ref.shape
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    rel = (o.float() - o_ref.float()).abs().max() / o_ref.float().abs().max()
    assert rel <= 2.0**-6, f"o: rel err {float(rel):.3e}"
    err = (lse - lse_ref).abs().max()
    assert err <= 1e-4, f"lse: abs err {float(err):.3e}"


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("Skv", FWD_RAGGED)
@pytest.mark.parametrize("Sq", FWD_RAGGED)
def test_k4_bf16_ragged_matches_plain(cuda, Sq, Skv, d):
    """bf16 K4 within two bf16 ulps of its plain version, lse within 1e-4,
    bit-equal on a repeat, at every pair of ragged lengths."""
    gen = torch.Generator().manual_seed(Sq + 7 * Skv + d)
    q = _rand(gen, 2, Sq, d, device=cuda).to(torch.bfloat16)
    k, v = (_rand(gen, 2, Skv, d, device=cuda).to(torch.bfloat16) for _ in range(2))
    _check_fwd("K4", flash.flash_attention, flash.flash_attention_plain, (q, k, v))


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("h,Sq", [(6, 183), (6, 512), (2, 1)])
def test_k4_bf16_folded_multiquery_matches_plain(cuda, h, Sq, d):
    """The multiquery fold: h heads' Sq query rows against one KV head of
    1655 rows, Sq = h·Sq' query rows of one group."""
    gen = torch.Generator().manual_seed(h * Sq + d)
    q = _rand(gen, 3, h * Sq, d, device=cuda).to(torch.bfloat16)
    k, v = (_rand(gen, 3, 1655, d, device=cuda).to(torch.bfloat16) for _ in range(2))
    _check_fwd("K4", flash.flash_attention, flash.flash_attention_plain, (q, k, v))


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("S,sep", [(300, 1), (300, 63), (300, 64), (300, 65), (300, 127),
                                   (300, 128), (300, 129), (300, 299), (300, 300),
                                   (2350, 1838)])
def test_k2a_bf16_sep_matches_plain(cuda, S, sep, d):
    """bf16 K2a with `sep` at one train row, around multiples of 64 and of
    128, at S − 1 (one test row) and S (none), and at the flagship's split;
    its inputs on a grid on which the projection is exact, so the lse holds
    the attention alone."""
    h, e = 6, 96
    gen = torch.Generator().manual_seed(S + sep + d)
    x3 = exact_grid(_rand(gen, 2, S, e, device=cuda)).to(torch.bfloat16)
    w_qkv = exact_grid(_rand(gen, 3, h, d, e, scale=e**-0.5, device=cuda), 1 / 256, 96)
    _check_fwd("K2a", item_fused.item_attention_core, item_fused.item_attention_core_plain,
               (x3, w_qkv, sep))


def test_k4_refuses_strided_operands_and_non_positive_scale(cuda):
    """The bf16 kernel reads q, k, v through TMA maps of (G, S, d): a strided
    view is refused, not copied; so is a scale the kernel cannot take."""
    gen = torch.Generator().manual_seed(5)
    q = _rand(gen, 2, 10, 16, device=cuda).to(torch.bfloat16)
    kv = _rand(gen, 2, 2, 20, 16, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention(q, kv[:, 0], kv[:, 1])
    k, v = kv[:, 0].contiguous(), kv[:, 1].contiguous()
    with pytest.raises(ValueError, match="positive scale"):
        flash.flash_attention(q, k, v, sm_scale=-0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,t,e,h,d", [((2, 37), 5, 48, 3, 16), ((1, 3, 20), 9, 64, 2, 32),
                                          ((1, 150), 30, 192, 6, 32), ((70,), 48, 32, 4, 8)])
def test_k7s_matches_plain(cuda, dtype, lead, t, e, h, d):
    """K7s against its plain version (dx, dW_qkv, dW_out, each relative to
    its own largest magnitude), the same bits on a second run."""
    gen = torch.Generator().manual_seed(sum(lead) + t + e)
    x, g = (_rand(gen, *lead, t, e, device=cuda).to(dtype) for _ in range(2))
    w_qkv = _rand(gen, 3, h, d, e, scale=e**-0.5, device=cuda)
    w_out = _rand(gen, h, d, e, scale=(h * d) ** -0.5, device=cuda)
    bound = 5e-5 if dtype == torch.float32 else 2.0**-6
    before = kernels.LAUNCHES["K7s"]
    got = fused.feature_attention_ln_bwd(x, w_qkv, w_out, g)
    again = fused.feature_attention_ln_bwd(x, w_qkv, w_out, g)
    assert kernels.LAUNCHES["K7s"] == before + 2
    for i, (a, c, w) in enumerate(zip(got, again, fused.feature_attention_ln_bwd_plain(x, w_qkv, w_out, g))):
        assert a.dtype == w.dtype and a.shape == w.shape, i
        assert torch.equal(a, c), f"output {i} differs between runs"
        rel = (a.float() - w.float()).abs().max() / w.float().abs().max()
        assert rel <= bound, f"output {i}: rel err {float(rel):.3e}"


def test_finetune_three_steps_on_the_card(cuda, tmp_path):
    """``fine_tune_mmpfn`` on the card (bf16, the default): three steps run
    K7, K8, K9 and K10 once per layer each, every loss and gradient norm is
    finite, and the classifier serves the snapshot."""
    import numpy as np

    from multimodalpfn_tpu_torch import MMPFNClassifier
    from multimodalpfn_tpu_torch.datasets.synthetic import toy_classification
    from multimodalpfn_tpu_torch.models.config import MixerConfig
    from multimodalpfn_tpu_torch.models.loading import save_model
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn

    cfg = ModelConfig(emsize=64, nhead=4, nhid_factor=2, nlayers=2, n_out=10, max_num_classes=10,
                      mixer=MixerConfig("MGM+CAP", mgm_heads=2, cap_heads=2, in_dim=96))
    base = tmp_path / "base.ckpt"
    save_model(base, tparams.init_params(torch.Generator().manual_seed(0), cfg), cfg)
    X, y = toy_classification(n=120, n_classes=3, seed=6)
    img = np.random.default_rng(6).standard_normal((120, 1, 96)).astype(np.float32)
    out = tmp_path / "ft.ckpt"
    kernels.reset_launches()
    hist = fine_tune_mmpfn(
        mixer_type="MGM+CAP", mgm_heads=2, cap_heads=2, features_per_group=1,
        path_to_base_model=base, save_path_to_fine_tuned_model=out,
        finetuning_config={"max_steps": 3, "learning_rate": 1e-3},
        X_train=X, image_train=img, y_train=y, random_seed=0,
    )
    assert hist["steps"] == 3 and hist["skipped_steps"] == 0
    assert np.isfinite(hist["train_loss"]).all() and np.isfinite(hist["grad_norm"]).all()
    assert {k: kernels.LAUNCHES[k] for k in NO_BACKWARD} == (
        {k: 3 * cfg.nlayers for k in ("K7", "K8", "K9", "K10")} | {"K7s": 0, "K11": 0})
    clf = MMPFNClassifier(model_path=out, mixer_type="MGM+CAP", mgm_heads=2, cap_heads=2,
                          n_estimators=2, device="cuda")
    clf.fit(X[:90], img[:90], y[:90])
    proba = clf.predict_proba(X[90:], img[90:])
    assert proba.shape == (30, 3)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("multiquery", [False, True])
def test_flash_path_finetune_three_steps_on_the_card(cuda, tmp_path, multiquery):
    """``fine_tune_mmpfn`` on the card, three bf16 steps. A checkpoint
    without the multiquery test block runs K4 forward and K11 backward in
    both item blocks of every layer, and never K2a, K2b, K9 or K10; the
    multiquery checkpoint, for contrast, runs the fused item sublayer (K10 +
    K9) and no K11. The snapshot keeps the key and the classifier serves
    it."""
    import numpy as np

    from multimodalpfn_tpu_torch import TabPFNClassifier
    from multimodalpfn_tpu_torch.datasets.synthetic import toy_classification
    from multimodalpfn_tpu_torch.models.loading import load_model, save_model
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn

    cfg = ModelConfig(emsize=64, nhead=4, nhid_factor=2, nlayers=2, n_out=10, max_num_classes=10,
                      multiquery_item_attention_for_test_set=multiquery)
    base = tmp_path / "base.ckpt"
    save_model(base, tparams.init_params(torch.Generator().manual_seed(0), cfg), cfg)
    X, y = toy_classification(n=120, n_classes=3, seed=7)
    out = tmp_path / "ft.ckpt"
    kernels.reset_launches()
    hist = fine_tune_mmpfn(
        mixer_type="none", mgm_heads=2, cap_heads=2, features_per_group=1,
        path_to_base_model=base, save_path_to_fine_tuned_model=out,
        finetuning_config={"max_steps": 3, "learning_rate": 1e-3},
        X_train=X, y_train=y, random_seed=0,
    )
    assert hist["steps"] == 3 and hist["skipped_steps"] == 0
    assert np.isfinite(hist["train_loss"]).all() and np.isfinite(hist["grad_norm"]).all()
    ran = dict(kernels.LAUNCHES)
    L = cfg.nlayers
    if multiquery:
        assert ran["K9"] == ran["K10"] == 3 * L and ran["K11"] == 0
    else:
        # K4 in both blocks of every layer: 3 training forwards, 4 validations
        assert ran["K11"] == 2 * 3 * L and ran["K4"] == 2 * L * (3 + 4)
        assert ran["K2a"] == ran["K2b"] == ran["K9"] == ran["K10"] == 0
    assert ran["K7"] == ran["K8"] == 3 * L and ran["K7s"] == 0
    assert load_model(out).config.multiquery_item_attention_for_test_set is multiquery
    clf = TabPFNClassifier(model_path=out, n_estimators=2, device="cuda")
    clf.fit(X[:90], y[:90])
    proba = clf.predict_proba(X[90:])
    assert proba.shape == (30, 3)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-5)


def _regression_base(tmp_path, emsize=64):
    """A small random regressor checkpoint (5000 bars over linspace(-12, 12))
    with its output projections filled in."""
    import numpy as np

    from chip_smoke import densify
    from multimodalpfn_tpu_torch.models.config import MixerConfig
    from multimodalpfn_tpu_torch.models.loading import save_model

    cfg = ModelConfig(emsize=emsize, nhead=4, nhid_factor=2, nlayers=2, n_out=5000, max_num_classes=0,
                      num_buckets=5000, mixer=MixerConfig("MGM+CAP", mgm_heads=2, cap_heads=2, in_dim=96))
    params = tparams.init_params(torch.Generator().manual_seed(0), cfg)
    densify(params, seed=1)
    base = tmp_path / "reg_base.ckpt"
    save_model(base, params, cfg, criterion_borders=np.linspace(-12, 12, 5001).astype(np.float32))
    return base


def _regression_data(n=120, seed=8):
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    img = rng.standard_normal((n, 1, 96)).astype(np.float32)
    y = X[:, 0] + 0.5 * X[:, 1] + rng.lognormal(sigma=0.5, size=n)
    return X, img, y


@pytest.mark.parametrize("fit_mode", ["fit_preprocessors", "fit_with_cache"])
def test_regressor_on_the_card_matches_the_cpu(cuda, tmp_path, fit_mode):
    """MMPFNRegressor in float32 on the card (the kernel path) against the
    same regressor on the CPU (the plain path): bar probabilities within
    1e-4, mean and median within 1e-4 of std(y); the counters show the
    served kernels of the mode and no backward kernel."""
    import numpy as np

    from multimodalpfn_tpu_torch import MMPFNRegressor

    base = _regression_base(tmp_path)
    X, img, y = _regression_data()
    kw = dict(model_path=base, mgm_heads=2, cap_heads=2, n_estimators=4, fit_mode=fit_mode,
              inference_precision="float32")
    cpu = MMPFNRegressor(device="cpu", **kw).fit(X[:90], img[:90], y[:90])
    want = cpu.predict(X[90:], img[90:], output_type="full")
    kernels.reset_launches()
    gpu = MMPFNRegressor(device="cuda", **kw).fit(X[:90], img[:90], y[:90])
    got = gpu.predict(X[90:], img[90:], output_type="full")
    ran = dict(kernels.LAUNCHES)
    np.testing.assert_allclose(np.exp(got["logits"]), np.exp(want["logits"]), atol=1e-4, rtol=0)
    std = float(np.std(y[:90]))
    for key in ("mean", "median"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-4 * std, rtol=0, err_msg=key)
    served = ("K4", "K3") if fit_mode == "fit_with_cache" else ("K2a", "K2b", "K3")
    assert all(ran[k] > 0 for k in served) and not any(ran[k] for k in NO_BACKWARD)


def test_regression_finetune_three_steps_on_the_card(cuda, tmp_path):
    """``fine_tune_mmpfn(task_type="regression")`` on the card (bf16): three
    steps run K7, K8, K9 and K10 once per layer each, every loss and
    gradient norm is finite, and MMPFNRegressor serves the snapshot."""
    import numpy as np

    from multimodalpfn_tpu_torch import MMPFNRegressor
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn

    base = _regression_base(tmp_path)
    X, img, y = _regression_data()
    out = tmp_path / "reg_ft.ckpt"
    kernels.reset_launches()
    hist = fine_tune_mmpfn(
        mixer_type="MGM+CAP", mgm_heads=2, cap_heads=2, features_per_group=1,
        path_to_base_model=base, save_path_to_fine_tuned_model=out, task_type="regression",
        validation_metric="rmse", finetuning_config={"max_steps": 3, "learning_rate": 1e-3},
        X_train=X, image_train=img, y_train=y, random_seed=0,
    )
    assert hist["steps"] == 3 and hist["skipped_steps"] == 0
    assert np.isfinite(hist["train_loss"]).all() and np.isfinite(hist["grad_norm"]).all()
    assert {k: kernels.LAUNCHES[k] for k in NO_BACKWARD} == (
        {k: 3 * 2 for k in ("K7", "K8", "K9", "K10")} | {"K7s": 0, "K11": 0})
    reg = MMPFNRegressor(model_path=out, mgm_heads=2, cap_heads=2, n_estimators=2, device="cuda")
    pred = reg.fit(X[:90], img[:90], y[:90]).predict(X[90:], img[90:])
    assert pred.shape == (30,) and np.isfinite(pred).all()


def _sweep_setup(tmp_path):
    import numpy as np

    from multimodalpfn_tpu_torch.datasets.synthetic import toy_classification
    from multimodalpfn_tpu_torch.models.loading import save_model

    cfg = ModelConfig(emsize=64, nhead=4, nhid_factor=2, nlayers=2, n_out=10, max_num_classes=10)
    base = tmp_path / "bare.ckpt"
    save_model(base, tparams.init_params(torch.Generator().manual_seed(0), cfg), cfg)
    X, y = toy_classification(n=120, n_classes=3, seed=6)
    img = np.random.default_rng(6).standard_normal((120, 1, 128)).astype(np.float32)
    return dict(mixer_type="MGM+CAP", features_per_group=1, path_to_base_model=str(base), X=X, image=img,
                y=y, static_seed=0), cfg.nlayers


def test_sweep_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """A padded 2-cell sweep (mgm 2 and 4, cap 2; one seed each), 3 float32
    steps on the card's kernel path against the CPU's plain path, the
    mixers' dropout off (a CUDA generator draws other masks than the CPU
    one): losses and validation errors within 1e-4 relative; K7-K10
    launched once per layer, run and step; bf16 runs finite."""
    import numpy as np

    from multimodalpfn_tpu_torch.models import mixers
    from multimodalpfn_tpu_torch.train.finetune_batch import fine_tune_batched_cells

    monkeypatch.setattr(mixers, "_dropout", lambda x, *a, **k: x)
    kw, L = _sweep_setup(tmp_path)
    kw["cells"] = [{"mgm_heads": 2, "cap_heads": 2, "seeds": [0]}, {"mgm_heads": 4, "cap_heads": 2, "seeds": [1]}]
    kw["finetuning_config"] = {"max_steps": 3, "learning_rate": 1e-3}
    kernels.reset_launches()
    card = fine_tune_batched_cells(compute_dtype="float32", **kw)
    launches = dict(kernels.LAUNCHES)
    cpu = fine_tune_batched_cells(device="cpu", **kw)
    np.testing.assert_allclose(card["history"]["train_loss"], cpu["history"]["train_loss"], rtol=1e-4)
    np.testing.assert_allclose([e for _, e in card["history"]["val_error"]],
                               [e for _, e in cpu["history"]["val_error"]], rtol=1e-4)
    assert {k: launches[k] for k in ("K7", "K8", "K9", "K10")} == {k: 2 * 3 * L for k in ("K7", "K8", "K9", "K10")}
    assert launches["K1"] == launches["K3"] == 2 * (3 + 4) * L
    bf16 = fine_tune_batched_cells(**kw)
    assert np.isfinite(bf16["history"]["train_loss"]).all() and bf16["history"]["skipped_steps"] == [0, 0]


@pytest.mark.parametrize("mixer_type", ["MGM+CAP", "MGM"])
def test_padded_sweep_equals_unpadded_on_the_card(cuda, tmp_path, mixer_type):
    """[a, b] against [a] alone on the card, float32, at lr 1e-12: losses
    within 1e-5 relative, the extracted mixers within 1e-9."""
    import numpy as np

    from multimodalpfn_tpu_torch.train.finetune_batch import extract_run_params, fine_tune_batched_cells

    kw, _ = _sweep_setup(tmp_path)
    kw.update(mixer_type=mixer_type, compute_dtype="float32",
              finetuning_config={"max_steps": 2, "learning_rate": 1e-12})
    a = {"mgm_heads": 2, "cap_heads": 2, "seeds": [0, 1]}
    both = fine_tune_batched_cells(cells=[a, {"mgm_heads": 4, "cap_heads": 2, "seeds": [2]}], **kw)
    alone = fine_tune_batched_cells(cells=[a], **kw)
    np.testing.assert_allclose(np.asarray(both["history"]["train_loss"])[:, :2], alone["history"]["train_loss"],
                               rtol=1e-5)
    for r in range(2):
        pb, pa = extract_run_params(both, r)[0], extract_run_params(alone, r)[0]
        for k, v in tparams.flatten_params(pa["mixer"]).items():
            torch.testing.assert_close(tparams.flatten_params(pb["mixer"])[k], v, rtol=0, atol=1e-9)


def _small_classifier_base(tmp_path):
    """A 2-layer, width-64 MGM+CAP classifier in the reference format, with
    120 rows of 3 classes and a 96-wide image embedding a row."""
    import numpy as np

    from multimodalpfn_tpu_torch.datasets.synthetic import toy_classification
    from multimodalpfn_tpu_torch.models.config import MixerConfig
    from multimodalpfn_tpu_torch.models.loading import save_model

    cfg = ModelConfig(emsize=64, nhead=4, nhid_factor=2, nlayers=2, n_out=10, max_num_classes=10,
                      mixer=MixerConfig("MGM+CAP", mgm_heads=2, cap_heads=2, in_dim=96))
    base = tmp_path / "base.ckpt"
    save_model(base, tparams.init_params(torch.Generator().manual_seed(0), cfg), cfg)
    X, y = toy_classification(n=120, n_classes=3, seed=6)
    img = np.random.default_rng(6).standard_normal((120, 1, 96)).astype(np.float32)
    return base, X, img, y


@pytest.mark.parametrize("fit_mode", ["fit_preprocessors", "fit_with_cache"])
def test_every_sync_of_a_warm_request_is_a_sync_span(cuda, tmp_path, fit_mode):
    """PyTorch's sync debug mode, over two warm pipelined requests: every
    sync it reports lies in a ``mmpfn.sync.*`` span, and every such span
    holds exactly one (`tools/torch_sync_audit.py`). A fitted
    ``fit_preprocessors`` request waits for the card once, at its fetch,
    and opens no upload span."""
    from multimodalpfn_tpu_torch import MMPFNClassifier
    from tools.torch_sync_audit import audit

    base, X, img, y = _small_classifier_base(tmp_path)
    clf = MMPFNClassifier(model_path=base, mixer_type="MGM+CAP", mgm_heads=2, cap_heads=2,
                          n_estimators=4, device="cuda", fit_mode=fit_mode)
    clf.fit(X[:90], img[:90], y[:90])
    for _ in range(2):
        clf.predict_proba_many([X[90:]] * 2, [img[90:]] * 2)
    result = audit(lambda: clf.predict_proba_many([X[90:]] * 2, [img[90:]] * 2))
    assert result.main_syncs() and result.unmatched() == [], result.report()
    if fit_mode == "fit_preprocessors":
        assert [s.span.name for s in result.main_syncs()] == ["mmpfn.sync.fetch"] * 2, result.report()
        assert not [s for s in result.spans if s.name == "mmpfn.sync.upload"], result.report()


def test_subspace_noise_is_kept_on_the_card(cuda):
    """The table on the card holds the CPU draw's bits, one tensor for a
    (seed, tokens, width, card) however the card is named."""
    from multimodalpfn_tpu_torch.models.params import get_subspace_noise

    got = get_subspace_noise(7, 31, 48, device="cuda")
    assert got.device == torch.device("cuda", torch.cuda.current_device())
    assert torch.equal(got.cpu(), get_subspace_noise(7, 31, 48))
    assert get_subspace_noise(7, 31, 48, device=torch.device("cuda", torch.cuda.current_device())) is got
    assert get_subspace_noise(7, 30, 48, device="cuda") is not got


def test_every_sync_of_a_warm_iteration_is_a_sync_span(cuda, tmp_path):
    """The same over the warm iterations of a ``fine_tune_mmpfn`` call, none
    of whose syncs is the upload of a noise table (kept on the card)."""
    from tools.torch_sync_audit import audit_finetune

    base, X, img, y = _small_classifier_base(tmp_path)
    iterations = audit_finetune(dict(
        mixer_type="MGM+CAP", mgm_heads=2, cap_heads=2, features_per_group=1,
        path_to_base_model=base, save_path_to_fine_tuned_model=tmp_path / "ft.ckpt",
        finetuning_config={"max_steps": 5, "learning_rate": 1e-3},
        X_train=X, image_train=img, y_train=y, random_seed=0, state_checkpoint_every=0), warm=2)
    assert len(iterations) == 2
    for it in iterations:
        assert it.main_syncs() and it.unmatched() == [], it.report()
        assert not [s for s in it.main_syncs() if "get_subspace_noise" in s.site], it.report()
