"""The reckoning of the fine-tune backward's launch sequences in
`chip_smoke.py` (`bwd_products`: what each launch of K7 and of both bodies
of K8 and of K10, their row passes and their sequences, reads and writes),
against phase 8's FLOP counts and the buffers that `ops/fused.py` and
`ops/item_fused.py` allocate; and the plain
version of the product tile's direct entry `kernels.gemm_bf16`. CPU only:
shapes on the meta device, no kernel launched.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from multimodalpfn_tpu_torch.ops import fused, item_fused, kernels

DTYPES = {"cd": torch.bfloat16, "f32": torch.float32}


def _products(seq):
    return [ln for ln in seq["launches"] if "M" in ln]


def _flops(prods):
    return sum(2 * p["M"] * p["N"] * p["K"] for p in prods)


@pytest.mark.parametrize("dims", [chip_smoke.FT_DIMS, (1, 5, 37, 21, 48, 3, 16, 96)])
def test_products_add_up_to_phase_8_flops(dims):
    """Each body's products add up to phase 8's FLOPs: the launches of the
    product tile, and K8's row pass's products on chip less the forward it
    recomputes (its z = x·W1 a second time); K10's two bodies likewise."""
    seqs = chip_smoke.bwd_products(dims)
    want = chip_smoke.bwd_flops(dims)
    for kid in ("K7", "K8", "K8 sequence", "K10", "K10 sequence"):
        got = _flops(_products(seqs[kid]))
        for ln in seqs[kid]["launches"]:
            on_chip = ln.get("products", [])
            got += _flops(on_chip) - _flops(p for p in on_chip if p["name"] in ln["recomputed"])
        assert got == want[kid.split()[0]], kid
    assert len(_products(seqs["K8 sequence"])) == 6 and len(_products(seqs["K7"])) == 6
    row_pass, *wgrads = seqs["K8"]["launches"]
    assert len(row_pass["products"]) == 5 and row_pass["recomputed"] == ["z=x.W1 again"]
    assert len(_products(seqs["K8"])) == 2 and all(ln["a_t"] for ln in _products(seqs["K8"]))


@pytest.mark.parametrize("dims", [chip_smoke.FT_DIMS, (1, 5, 37, 21, 48, 3, 16, 96)])
def test_products_name_the_buffers_fused_allocates(dims):
    """Every buffer of the reckoning that `ops/fused.py` or
    `ops/item_fused.py` allocates has the
    shape and dtype it allocates (bf16 compute dtype), every slab view fits
    in the workspace, each product's operands have its shapes, and every
    launch reads and writes named buffers only."""
    b, t, S, _, e, h, d, nhid = dims
    rows = b * t * S
    x = torch.empty((b, t, S, e), dtype=torch.bfloat16, device="meta")
    x3, o = x.reshape(b * t, S, e), torch.empty((b * t, S, h * d), dtype=torch.bfloat16, device="meta")
    allocated = {
        "K8": dict(zip(("gz", "du_c", "dz", "dx", "dw1", "dw2", "work"),
                       fused._mlp_bwd_wg_buffers(x, rows, nhid))),
        "K8 sequence": dict(zip(("gz", "gzg", "u", "du", "du_c", "dz", "dx", "dw1", "dw2", "work"),
                                fused._mlp_bwd_buffers(x, rows, nhid))),
        "K7": dict(zip(("qkv", "o", "u", "du", "du_c", "do", "dqkv", "dx", "dwqkv", "dwout", "work"),
                       fused._attn_bwd_buffers(x, rows, h * d))),
        "K10": dict(zip(("du_c", "do", "delta", "dw", "work"),
                        item_fused._epilogue_bwd_buffers(x3, o, h, "wgmma"))),
        "K10 sequence": dict(zip(("u", "du_c", "do32", "do", "delta", "dw", "work"),
                                 item_fused._epilogue_bwd_buffers(x3, o, h, "sequence"))),
    }
    for kid, seq in chip_smoke.bwd_products(dims).items():
        bufs = seq["buffers"]
        for name, tensor in allocated[kid].items():
            shape, dt = bufs[name]
            assert math.prod(shape) == tensor.numel() and DTYPES[dt] == tensor.dtype, (kid, name)
        work = allocated[kid]["work"].numel()
        views = [n for n in bufs if n.startswith("slabs_")]
        assert views and max(math.prod(bufs[n][0]) for n in views) == work, kid
        for ln in seq["launches"]:
            assert set(ln["reads"] + ln["writes"]) <= set(bufs), (kid, ln["name"])
        for ln in _products(seq):
            a_shape = (ln["K"], ln["M"]) if ln["a_t"] else (ln["M"], ln["K"])
            b_shape = (ln["N"], ln["K"]) if ln["b_t"] else (ln["K"], ln["N"])
            assert math.prod(bufs[ln["a"]][0]) == math.prod(a_shape), (kid, ln["name"])
            assert math.prod(bufs[ln["b"]][0]) == math.prod(b_shape), (kid, ln["name"])
            assert bufs[ln["a"]][0][-1] == a_shape[-1], (kid, ln["name"])
            assert bufs[ln["b"]][0][-1] == b_shape[-1], (kid, ln["name"])


def test_launch_bytes_of_the_flagship():
    """K8's sequence (the body of the float32 parity mode) moves 1.25 GB in
    bf16 at the flagship shape (0.374 ms at 3.35 TB/s), its row pass with
    the two weight gradients 0.53 GB (0.159 ms), K7's products and row
    kernels 0.86 GB."""
    seqs = chip_smoke.bwd_products(chip_smoke.FT_DIMS)
    total = {kid: sum(chip_smoke.launch_bytes(seq, ln, 2) for ln in seq["launches"])
             for kid, seq in seqs.items()}
    assert total["K8 sequence"] == 1_251_790_848
    assert total["K8"] == 531_293_184
    assert total["K7"] == 858_806_784


@pytest.mark.parametrize("a_t,b_t", [(False, False), (False, True), (True, False), (True, True)])
def test_gemm_bf16_plain_on_the_cpu(a_t, b_t):
    """On the CPU `kernels.gemm_bf16` is its plain version: op(A)·op(B) of
    the bf16 operands in float32, whatever chunk is asked for."""
    rng = np.random.default_rng(int(a_t) * 2 + int(b_t))
    M, N, K = 37, 24, 70
    a = torch.from_numpy(rng.standard_normal((K, M) if a_t else (M, K))).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((N, K) if b_t else (K, N))).to(torch.bfloat16)
    want = (a.float().numpy().T if a_t else a.float().numpy()).astype(np.float64) @ (
        b.float().numpy().T if b_t else b.float().numpy()).astype(np.float64)
    for k_chunk in (0, 64):
        got = kernels.gemm_bf16(a, b, a_t, b_t, k_chunk)
        assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
