"""Which body of K8 (`csrc/mlp_ln_bwd.cu`) the port picks, `ops/fused.py`'s
buffers for its row pass against `chip_smoke.bwd_products`' reckoning, and
the bytes the row pass's launches move at the flagship shape. CPU only:
shapes on the meta device and pure Python, no kernel launched; the row pass
itself is held to the plain version on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py` phase 8).
"""

import math

import pytest
import torch

import chip_smoke
from multimodalpfn_tpu_torch.ops import fused

DTYPES = {"cd": torch.bfloat16, "f32": torch.float32}


@pytest.mark.parametrize("e", [64, 128, 192])
@pytest.mark.parametrize("nhid", [64, 256, 768, 1024])
def test_row_pass_at_the_widths_of_k3s_wgmma_body(e, nhid):
    assert fused.mlp_bwd_body(torch.bfloat16, e, nhid) == "wgmma"
    assert fused.mlp_ln_body(torch.bfloat16, e, nhid) == "wgmma"


@pytest.mark.parametrize(
    "dtype,e,nhid",
    [(torch.float32, 192, 768), (torch.float32, 64, 256), (torch.bfloat16, 32, 64),
     (torch.bfloat16, 48, 96), (torch.bfloat16, 96, 384), (torch.bfloat16, 160, 640),
     (torch.bfloat16, 256, 1024), (torch.bfloat16, 192, 100), (torch.bfloat16, 64, 96),
     (torch.bfloat16, 2, 4)],
)
def test_sequence_elsewhere(dtype, e, nhid):
    """float32 (the parity mode) and bf16 at widths the row pass does not
    take run the sequence."""
    assert fused.mlp_bwd_body(dtype, e, nhid) == "sequence"


@pytest.mark.parametrize(
    "dtype,e,nhid,error",
    [(torch.float16, 192, 768, TypeError), (torch.float64, 64, 256, TypeError),
     (torch.bfloat16, 191, 768, ValueError), (torch.float32, 0, 768, ValueError),
     (torch.bfloat16, 258, 1024, ValueError), (torch.bfloat16, 192, 0, ValueError),
     (torch.float32, 64, 6, ValueError)],
)
def test_raises_where_k3_raises(dtype, e, nhid, error):
    with pytest.raises(error, match="K3"):
        fused.mlp_ln_body(dtype, e, nhid)
    with pytest.raises(error, match="K8"):
        fused.mlp_bwd_body(dtype, e, nhid)


@pytest.mark.parametrize("dims", [chip_smoke.FT_DIMS, (1, 3, 40, 30, 64, 2, 32, 256),
                                  (1, 1, 100, 90, 192, 6, 32, 768)])
def test_row_pass_buffers_match_the_reckoning(dims):
    """The row pass's allocations, in its C entry's order, have the shapes
    and dtypes `bwd_products` gives them, and no float32 gzg, u or du."""
    b, t, S, _, e, _, _, nhid = dims
    rows = b * t * S
    x = torch.empty((b, t, S, e), dtype=torch.bfloat16, device="meta")
    bufs = chip_smoke.bwd_products(dims)["K8"]["buffers"]
    names = ("gz", "du_c", "dz", "dx", "dw1", "dw2", "work")
    got = fused._mlp_bwd_wg_buffers(x, rows, nhid)
    assert len(got) == len(names)
    for name, tensor in zip(names, got):
        shape, dt = bufs[name]
        assert math.prod(shape) == tensor.numel() and DTYPES[dt] == tensor.dtype, name
        assert tensor.shape[-1] == shape[-1], name
    assert not {"gzg", "u", "du"} & set(bufs)
    assert {"gzg", "u", "du"} <= set(chip_smoke.bwd_products(dims)["K8 sequence"]["buffers"])


def test_row_pass_bytes_at_the_flagship():
    """At x (1, 30, 1838, 192), nhid 768, bf16: the row pass reads x, g and
    the weights and writes gz, du_c, dz and dx (254.7 MB); each weight
    gradient reads its two operands, writes its 27 slabs and sums them
    (138.3 MB)."""
    seq = chip_smoke.bwd_products(chip_smoke.FT_DIMS)["K8"]
    per = {ln["name"]: chip_smoke.launch_bytes(seq, ln, 2) for ln in seq["launches"]}
    assert per == {"row pass": 254_674_944, "dW1=xt.dz": 121_794_048, "sum_slabs dW1": 16_515_072,
                   "dW2=gzt.du": 121_794_048, "sum_slabs dW2": 16_515_072}
    assert sum(per.values()) == 531_293_184
