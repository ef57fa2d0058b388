"""DINOv2 ViT-B/14 image encoder (embedding generation, layer 0): the port of
the JAX package's `multimodalpfn_tpu/modal/dinov2.py`.

The reference runs `vit_base` + ``forward_features(...)['x_norm_clstoken']``
(`mmpfn/datasets/pad_ufes_20.py:78-96`): patch 14, embed 768, 12 blocks, 12
heads, LayerScale, no register tokens. This is the same ViT as plain
functions on a params dict of stacked block leaves ``(depth, ...)``, as the
JAX package lays it out, and it loads the published
``dinov2_vitb14_pretrain.pth``, so cached embeddings are interchangeable.

Attention is unmasked softmax attention at d = 768 / 12 = 64, which is what
K4 computes: q, k and v go as contiguous ``(B·heads, N, 64)`` tensors into
`ops/flash.flash_attention` (the kernel on a CUDA tensor, its plain version
on the CPU or with ``use_kernels=False``). The dense products are
``torch.matmul``, as the JAX package left them to XLA.

Dtypes follow what the JAX block computes, not its scan carry. With a bf16
compute dtype every bias is float32, so a block returns float32 and
``lax.scan`` refuses the bf16 carry it was given (`dinov2.py:111`: the JAX
package runs in float32 only). Here the embedded tokens are rounded to the
compute dtype once at entry and the residual stream is float32 from the
first block's output on. A product the JAX package asks for with
``preferred_element_type=float32`` (the patch conv, the attention einsums)
is not rounded to bf16; the four dense products are, before their float32
bias (``x.astype(cd) @ w.astype(cd) + b``).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from multimodalpfn_tpu_torch.estimator.base import resolve_device
from multimodalpfn_tpu_torch.models.params import params_from_jax, tree_map
from multimodalpfn_tpu_torch.models.transformer import DTYPES
from multimodalpfn_tpu_torch.ops import flash

# the leaves a forward reads as product operands (kept in the compute dtype
# by `prepare_params`); every other leaf is read in float32
_MATRICES = ("qkv_w", "proj_w", "fc1_w", "fc2_w")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 14
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    pos_embed_size: int = 37  # 518 / 14
    layerscale: bool = True
    compute_dtype: str = "bfloat16"


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with float32 statistics, returned in x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """``x.astype(cd) @ w.astype(cd) + b``: the product rounded to ``cd``,
    the float32 bias added after."""
    return (x.to(cd) @ w.to(cd)).float() + b


def _attn(x: torch.Tensor, p: dict, nheads: int, cd: torch.dtype, use_kernels: bool) -> torch.Tensor:
    B, N, D = x.shape
    hd = D // nheads
    qkv = _dense(x, p["qkv_w"], p["qkv_b"], cd).to(cd)
    # (B, N, 3, heads, hd) -> three contiguous (B·heads, N, hd) blocks
    qkv = qkv.reshape(B, N, 3, nheads, hd).permute(2, 0, 3, 1, 4).reshape(3, B * nheads, N, hd)
    attention = flash.flash_attention if use_kernels else flash.flash_attention_plain
    o, _ = attention(qkv[0], qkv[1], qkv[2], 1.0 / math.sqrt(hd))
    o = o.reshape(B, nheads, N, hd).transpose(1, 2).reshape(B, N, D)
    return _dense(o, p["proj_w"], p["proj_b"], cd)


def _block(x: torch.Tensor, p: dict, cfg: ViTConfig, use_kernels: bool) -> torch.Tensor:
    cd = DTYPES[cfg.compute_dtype]
    h = _attn(_ln(x, p["norm1_g"], p["norm1_b"]), p, cfg.num_heads, cd, use_kernels)
    if cfg.layerscale:
        h = h * p["ls1"]
    x = x + h  # float32 from here on, as the JAX block's output
    z = _ln(x, p["norm2_g"], p["norm2_b"])
    z = F.gelu(_dense(z, p["fc1_w"], p["fc1_b"], cd), approximate="none")
    z = _dense(z, p["fc2_w"], p["fc2_b"], cd)
    if cfg.layerscale:
        z = z * p["ls2"]
    return x + z


def interpolate_pos_embed(pos: torch.Tensor, grid: int, base: int) -> torch.Tensor:
    """Bicubic pos-embed interpolation for inputs other than 518 px (reference
    `dino_v2/models/vision_transformer.py` interpolate_pos_encoding), as
    ``jax.image.resize(..., "bicubic")`` computes it: Keys' cubic (a = -0.5)
    with antialiasing, which matters when the grid shrinks (without it the
    37 -> 24 grid of 336 px moves by about the largest value itself)."""
    if grid == base:
        return pos
    cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    D = pos.shape[-1]
    patch = patch_pos.reshape(1, base, base, D).permute(0, 3, 1, 2)
    patch = F.interpolate(patch, size=(grid, grid), mode="bicubic", align_corners=False,
                          antialias=True)
    return torch.cat([cls_pos, patch.permute(0, 2, 3, 1).reshape(1, grid * grid, D)], dim=1)


def _block_params(blocks: dict, i: int) -> dict:
    return {k: v[i] for k, v in blocks.items()}


@torch.no_grad()
def forward_features(
    params: dict, cfg: ViTConfig, images: torch.Tensor, *, use_kernels: bool | None = None
) -> dict:
    """images ``(B, C, H, W)`` float (the caller normalizes), on the params'
    device. Returns ``{'x_norm_clstoken': (B, D), 'x_norm_patchtokens':
    (B, N, D)}`` in float32. ``use_kernels`` (None = on a CUDA device) sends
    the attention through K4; False runs its plain version."""
    use_kernels = images.device.type == "cuda" if use_kernels is None else use_kernels
    cd = DTYPES[cfg.compute_dtype]
    B, C, H, W = images.shape
    ps, D = cfg.patch_size, cfg.embed_dim
    grid = H // ps
    if W // ps != grid:
        raise ValueError(f"images must give a square patch grid, got {H} x {W} at patch {ps}")
    # the patch conv (stride = kernel = ps, VALID) as one product over
    # (C, ps, ps) patches: operands rounded to the compute dtype, summed in
    # float32 and not rounded after (preferred_element_type=float32)
    x = images[:, :, : grid * ps, : grid * ps].to(cd).float()
    x = x.reshape(B, C, grid, ps, grid, ps).permute(0, 2, 4, 1, 3, 5).reshape(B, grid * grid, -1)
    x = x @ params["patch_w"].to(cd).float().reshape(D, -1).T + params["patch_b"]
    cls = params["cls_token"].float().expand(B, 1, D)
    x = torch.cat([cls, x], dim=1)
    x = x + interpolate_pos_embed(params["pos_embed"].float(), grid, cfg.pos_embed_size)
    x = x.to(cd)
    for i in range(cfg.depth):
        x = _block(x, _block_params(params["blocks"], i), cfg, use_kernels)
    x = _ln(x, params["norm_g"], params["norm_b"]).float()
    return {"x_norm_clstoken": x[:, 0], "x_norm_patchtokens": x[:, 1:]}


def _stacked(sd: dict, depth: int, name: str, transpose: bool = False) -> torch.Tensor:
    leaves = [sd[f"blocks.{i}.{name}"] for i in range(depth)]
    return torch.stack([t.T if transpose else t for t in leaves]).float().contiguous()


def load_dinov2_vitb14(path: str | Path, device: str | torch.device = "cuda") -> tuple[dict, ViTConfig]:
    """The published torch ``dinov2_vitb14_pretrain.pth`` state dict as a
    params dict on ``device`` (which must exist: without CUDA pass
    ``device="cpu"``), with the bf16 `ViTConfig`."""
    device = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    cfg = ViTConfig()
    L, D = cfg.depth, cfg.embed_dim
    blocks = {
        "norm1_g": _stacked(sd, L, "norm1.weight"),
        "norm1_b": _stacked(sd, L, "norm1.bias"),
        "qkv_w": _stacked(sd, L, "attn.qkv.weight", transpose=True),
        "qkv_b": _stacked(sd, L, "attn.qkv.bias"),
        "proj_w": _stacked(sd, L, "attn.proj.weight", transpose=True),
        "proj_b": _stacked(sd, L, "attn.proj.bias"),
        "ls1": _stacked(sd, L, "ls1.gamma"),
        "ls2": _stacked(sd, L, "ls2.gamma"),
        "norm2_g": _stacked(sd, L, "norm2.weight"),
        "norm2_b": _stacked(sd, L, "norm2.bias"),
        "fc1_w": _stacked(sd, L, "mlp.fc1.weight", transpose=True),
        "fc1_b": _stacked(sd, L, "mlp.fc1.bias"),
        "fc2_w": _stacked(sd, L, "mlp.fc2.weight", transpose=True),
        "fc2_b": _stacked(sd, L, "mlp.fc2.bias"),
    }
    params = {
        "patch_w": sd["patch_embed.proj.weight"],  # (D, 3, 14, 14)
        "patch_b": sd["patch_embed.proj.bias"],
        "cls_token": sd["cls_token"].reshape(1, 1, D),
        "pos_embed": sd["pos_embed"],
        "norm_g": sd["norm.weight"],
        "norm_b": sd["norm.bias"],
        "blocks": blocks,
    }
    return tree_map(lambda t: t.float().to(device), params), cfg


def init_vit_params(gen: torch.Generator, cfg: ViTConfig) -> dict:
    """Random init on the CPU from ``gen`` (testing without the published
    weights): N(0, 0.02²) weights, tokens and positions, zero biases, unit
    norms and LayerScale. The numbers differ from the JAX package's
    `init_vit_params` for the same seed; `vit_params_from_jax` carries JAX
    weights over where the two must agree."""
    D, depth, hidden = cfg.embed_dim, cfg.depth, cfg.embed_dim * cfg.mlp_ratio

    def nrm(*shape):
        return 0.02 * torch.randn(shape, generator=gen)

    blocks = {
        "norm1_g": torch.ones(depth, D),
        "norm1_b": torch.zeros(depth, D),
        "qkv_w": nrm(depth, D, 3 * D),
        "qkv_b": torch.zeros(depth, 3 * D),
        "proj_w": nrm(depth, D, D),
        "proj_b": torch.zeros(depth, D),
        "ls1": torch.ones(depth, D),
        "ls2": torch.ones(depth, D),
        "norm2_g": torch.ones(depth, D),
        "norm2_b": torch.zeros(depth, D),
        "fc1_w": nrm(depth, D, hidden),
        "fc1_b": torch.zeros(depth, hidden),
        "fc2_w": nrm(depth, hidden, D),
        "fc2_b": torch.zeros(depth, D),
    }
    n = cfg.pos_embed_size**2 + 1
    return {
        "patch_w": nrm(D, 3, cfg.patch_size, cfg.patch_size),
        "patch_b": torch.zeros(D),
        "cls_token": nrm(1, 1, D),
        "pos_embed": nrm(1, n, D),
        "norm_g": torch.ones(D),
        "norm_b": torch.zeros(D),
        "blocks": blocks,
    }


def vit_params_from_jax(tree: dict, device: str | torch.device = "cpu") -> dict:
    """The JAX package's ViT params (numpy leaves, ``jax.device_get``) as a
    params dict: the layouts are shared, so this is a leaf-wise copy."""
    return params_from_jax(tree, device)


def prepare_params(params: dict, cfg: ViTConfig, device: str | torch.device) -> dict:
    """The params on ``device``, the dense products' weights in the compute
    dtype and every other leaf in float32. `embed_images` calls it on every
    call; a caller that embeds batch after batch calls it once first, and the
    calls after find nothing to move."""
    cd = DTYPES[cfg.compute_dtype]
    out = {k: v.to(device=device, dtype=torch.float32) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: v.to(device=device, dtype=cd if k in _MATRICES else torch.float32)
                     for k, v in params["blocks"].items()}
    return out


def embed_images(
    params: dict,
    cfg: ViTConfig,
    images: np.ndarray,
    *,
    batch_size: int = 16,
    device: str | torch.device = "cuda",
    use_kernels: bool | None = None,
) -> np.ndarray:
    """``(B, N, C, H, W)`` float images in [0, 1] -> CLS embeddings ``(B, N,
    D)`` float32, ``batch_size`` images a forward, mirroring the reference's
    batched embedding loop (`datasets/pad_ufes_20.py:91-103`). Runs on
    ``device`` (without CUDA pass ``device="cpu"``); every image's embedding
    is its own, so batching does not change it beyond summation order."""
    device = resolve_device(device)
    params = prepare_params(params, cfg, device)
    B, N = images.shape[:2]
    flat = np.asarray(images, dtype=np.float32).reshape(-1, *images.shape[2:])
    outs = []
    for i in range(0, flat.shape[0], batch_size):
        chunk = torch.from_numpy(np.ascontiguousarray(flat[i : i + batch_size])).to(device)
        cls = forward_features(params, cfg, chunk, use_kernels=use_kernels)["x_norm_clstoken"]
        outs.append(cls.cpu().numpy())
    return np.concatenate(outs).reshape(B, N, -1)
