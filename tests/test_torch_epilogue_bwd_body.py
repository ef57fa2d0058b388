"""Which body of K10 (`csrc/item_epilogue_bwd.cu`) the port picks,
`ops/item_fused.py`'s buffers for each body against
`chip_smoke.bwd_products`' reckoning, and the bytes each body's launches
move at the flagship shape. CPU only: shapes on the meta device and pure
Python, no kernel launched; the row pass itself is held to the plain version
on the card (`tests/test_torch_cuda.py`, `chip_smoke.py` phase 8).
"""

import math

import pytest
import torch

import chip_smoke
from multimodalpfn_tpu_torch.ops import item_fused

DTYPES = {"cd": torch.bfloat16, "f32": torch.float32}


@pytest.mark.parametrize("e", [64, 128, 192])
@pytest.mark.parametrize("h,d", [(2, 32), (4, 32), (6, 32), (8, 32), (4, 48), (8, 8), (1, 64),
                                 (2, 128), (16, 16), (24, 8)])
def test_row_pass_at_the_widths_of_k2bs_wgmma_body(e, h, d):
    """bf16 at e = 64, 128, 192 with h·d a multiple of 64 up to 256 and d a
    multiple of 8 (a head may span the row pass's 64-column chunks) takes
    the row pass, where K2b takes its wgmma body."""
    assert item_fused.item_epilogue_bwd_body(torch.bfloat16, e, h * d, d) == "wgmma"
    assert item_fused.item_epilogue_body(torch.bfloat16, e, h * d) == "wgmma"


@pytest.mark.parametrize(
    "dtype,e,h,d",
    [(torch.float32, 192, 6, 32), (torch.float32, 64, 2, 32), (torch.float32, 128, 8, 8),
     (torch.bfloat16, 32, 2, 32), (torch.bfloat16, 96, 3, 32), (torch.bfloat16, 160, 5, 32),
     (torch.bfloat16, 256, 8, 32), (torch.bfloat16, 192, 3, 32), (torch.bfloat16, 192, 10, 32),
     (torch.bfloat16, 192, 16, 4), (torch.bfloat16, 192, 16, 12), (torch.bfloat16, 48, 3, 16),
     (torch.bfloat16, 2, 1, 4)],
)
def test_sequence_elsewhere(dtype, e, h, d):
    """float32 (the parity mode) always, and bf16 at widths the row pass
    does not take (e not 64, 128 or 192; h·d not a multiple of 64 or above
    256; d not a multiple of 8), run the sequence."""
    assert item_fused.item_epilogue_bwd_body(dtype, e, h * d, d) == "sequence"


@pytest.mark.parametrize(
    "dtype,e,hd,d,error",
    [(torch.float16, 192, 192, 32, TypeError), (torch.float64, 64, 64, 32, TypeError),
     (torch.bfloat16, 0, 192, 32, ValueError), (torch.float32, 192, 192, 0, ValueError),
     (torch.bfloat16, 192, 100, 32, ValueError), (torch.bfloat16, 192, 16, 32, ValueError)],
)
def test_raises_where_no_body_takes_it(dtype, e, hd, d, error):
    with pytest.raises(error, match="K10"):
        item_fused.item_epilogue_bwd_body(dtype, e, hd, d)


@pytest.mark.parametrize("dims", [chip_smoke.FT_DIMS, (1, 3, 100, 90, 192, 4, 48, 768),
                                  (1, 30, 201, 150, 64, 2, 32, 256)])
@pytest.mark.parametrize("body", ["wgmma", "sequence"])
def test_buffers_match_the_reckoning(dims, body):
    """Each body's allocations, in its C entry's order, have the shapes and
    dtypes `bwd_products` gives them; the row pass allocates no float32 u
    or do32, the sequence both."""
    b, t, S, _, e, h, d, _ = dims
    G = b * t
    x3 = torch.empty((G, S, e), dtype=torch.bfloat16, device="meta")
    o = torch.empty((G, S, h * d), dtype=torch.bfloat16, device="meta")
    kid = "K10" if body == "wgmma" else "K10 sequence"
    bufs = chip_smoke.bwd_products(dims)[kid]["buffers"]
    names = ("du_c", "do", "delta", "dw", "work")
    if body == "sequence":
        names = ("u", "du_c", "do32", "do", "delta", "dw", "work")
    got = item_fused._epilogue_bwd_buffers(x3, o, h, body)
    assert len(got) == len(names)
    for name, tensor in zip(names, got):
        shape, dt = bufs[name]
        assert math.prod(shape) == tensor.numel() and DTYPES[dt] == tensor.dtype, name
        assert tensor.shape[-1] == shape[-1], name
    assert ({"u", "do32"} & set(bufs)) == (set() if body == "wgmma" else {"u", "do32"})


def test_launch_bytes_at_the_flagship():
    """At x (30, 1838, 192), h = 6, d = 32, bf16: the row pass reads x, o, g
    and W_out and writes du, do and delta (107.3 MB); the weight gradient
    reads o and du, writes its 27 slabs and sums them (50.5 MB): 157.7 MB
    in all, 0.047 ms at 3.35 TB/s, against the sequence's 369.5 MB (0.110
    ms), whose float32 u and do32 each make a round trip; the function's
    own bytes, phase 8's bound, are 107.4 MB (0.032 ms)."""
    seqs = chip_smoke.bwd_products(chip_smoke.FT_DIMS)
    per = {kid: {ln["name"]: chip_smoke.launch_bytes(seq, ln, 2) for ln in seq["launches"]}
           for kid, seq in seqs.items() if kid.startswith("K10")}
    assert per["K10"] == {"row pass": 107_265_888, "dW_out=ot.du": 46_328_832,
                          "sum_slabs dW_out": 4_128_768}
    assert per["K10 sequence"] == {"u=x+o.Wout": 84_768_768, "ln_bwd": 84_695_040,
                                   "do=du.Woutt": 63_595_008, "delta": 86_018_400,
                                   "dW_out=ot.du": 46_328_832, "sum_slabs dW_out": 4_128_768}
    assert sum(per["K10"].values()) == 157_723_488
    assert sum(per["K10 sequence"].values()) == 369_534_816
    b, t, S, _, e, h, d, _ = chip_smoke.FT_DIMS
    R = b * t * S
    function_bytes = R * (3 * e + 2 * h * d) * 2 + b * t * h * S * 4 + h * d * e * (2 + 4)
    assert function_bytes == 107_413_344
    assert chip_smoke.bound(chip_smoke.bwd_flops(chip_smoke.FT_DIMS)["K10"], function_bytes, "bf16") == (
        pytest.approx(function_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3), "bytes")
