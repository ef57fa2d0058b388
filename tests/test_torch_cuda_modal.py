"""The modality encoders' kernel path on a CUDA device: K4 at DINOv2's shape
(16 images at 336 px: G = 16 x 12 heads, 577 tokens, d = 64) against its
plain version, and the port's DINOv2 and ELECTRA on the card against the
same functions on the CPU. Marked ``cuda``: each test skips (in a fixture)
where there is no card; ``python3 chip_smoke.py`` (phases 2, 22 and 23) runs
the same checks at full width.
"""

import dataclasses

import numpy as np
import pytest
import torch

from multimodalpfn_tpu_torch.modal import dinov2, electra
from multimodalpfn_tpu_torch.ops import flash, kernels

pytestmark = pytest.mark.cuda

# float32: summation order only; bf16: two bf16 ulps of the largest output
F32_REL, BF16_REL = 5e-5, 2.0**-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("dtype,bound", [(torch.float32, F32_REL), (torch.bfloat16, BF16_REL)])
def test_k4_at_the_vit_shape_matches_plain(cuda, dtype, bound):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(192, 577, 64, generator=g).to(cuda, dtype) for _ in range(3))
    before = kernels.LAUNCHES["K4"]
    o, lse = flash.flash_attention(q, k, v, 0.125)
    assert kernels.LAUNCHES["K4"] == before + 1
    want_o, want_lse = flash.flash_attention_plain(q, k, v, 0.125)
    assert _rel(o, want_o) <= bound
    assert float((lse - want_lse).abs().max()) <= 1e-4


@pytest.mark.parametrize("compute_dtype,bound", [("float32", 1e-4), ("bfloat16", BF16_REL)])
def test_dinov2_kernel_path_matches_plain_path(cuda, compute_dtype, bound):
    """Two ViT-B blocks at 336 px: K4 in every block, against the plain
    attention on the card."""
    cfg = dinov2.ViTConfig(depth=2, compute_dtype=compute_dtype)
    params = dinov2.init_vit_params(torch.Generator().manual_seed(0), cfg)
    imgs = np.random.default_rng(0).uniform(size=(4, 1, 3, 336, 336)).astype(np.float32)
    before = kernels.LAUNCHES["K4"]
    got = dinov2.embed_images(params, cfg, imgs, batch_size=4, device=cuda)
    assert kernels.LAUNCHES["K4"] == before + 2
    want = dinov2.embed_images(params, cfg, imgs, batch_size=4, device=cuda, use_kernels=False)
    assert got.shape == (4, 1, 768) and np.isfinite(got).all()
    assert np.abs(got - want).max() / np.abs(want).max() <= bound


def test_dinov2_and_electra_on_the_card_match_the_cpu(cuda):
    # d = 16, a head width K4 takes
    vcfg = dinov2.ViTConfig(embed_dim=64, depth=2, num_heads=4, mlp_ratio=2, compute_dtype="float32")
    vparams = dinov2.init_vit_params(torch.Generator().manual_seed(1), vcfg)
    imgs = np.random.default_rng(1).uniform(size=(5, 2, 3, 56, 56)).astype(np.float32)
    got = dinov2.embed_images(vparams, vcfg, imgs, batch_size=4, device=cuda)
    want = dinov2.embed_images(vparams, vcfg, imgs, batch_size=4, device="cpu")
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4

    ecfg = electra.ElectraConfig(vocab_size=100, hidden=64, layers=2, heads=4, intermediate=128,
                                 max_position=40)
    eparams = electra.init_params(torch.Generator().manual_seed(2), ecfg)
    ids = np.random.default_rng(2).integers(0, 100, size=(5, 33))
    mask = (np.arange(33)[None] < np.array([[33], [20], [5], [33], [9]])).astype(np.int64)
    got = electra.cls_embeddings(eparams, ecfg, ids, mask, batch_size=2, device=cuda)
    want = electra.cls_embeddings(eparams, ecfg, ids, mask, batch_size=2, device="cpu")
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4
    bf16 = electra.cls_embeddings(eparams, dataclasses.replace(ecfg, compute_dtype="bfloat16"), ids,
                                  mask, device=cuda)
    assert np.isfinite(bf16).all()
