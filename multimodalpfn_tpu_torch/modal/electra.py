"""ELECTRA text encoder (layer 0): the port of the JAX package's
`multimodalpfn_tpu/modal/electra.py`.

The reference embeds free-text columns with the CLS token of HF
``google/electra-base-discriminator`` (`mmpfn/datasets/cloth.py:57-88`,
`datasets/petfinder.py:152-188`). This is the same post-LN BERT-style encoder
as plain functions on a params dict of stacked layer leaves ``(layers,
...)``, as the JAX package lays it out, with a converter from the HF state
dict; `modal/text.py` tokenizes and calls it.

Padded keys get an additive -1e30 in float32 before the softmax, so the
attention is masked and stays plain PyTorch: K4 takes no key mask, and the
JAX package has no masked flash kernel either. As in `modal/dinov2.py`,
with a bf16 compute dtype the residual stream is float32 from the first
layer's output on (the JAX ``lax.scan`` refuses that carry: it runs in
float32 only).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from multimodalpfn_tpu_torch.estimator.base import resolve_device
from multimodalpfn_tpu_torch.modal.dinov2 import _ln
from multimodalpfn_tpu_torch.models.params import params_from_jax, params_to
from multimodalpfn_tpu_torch.models.transformer import DTYPES


@dataclass(frozen=True)
class ElectraConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_position: int = 512
    type_vocab: int = 2
    embedding_size: int = 768  # == hidden for -base; smaller for -small
    layer_norm_eps: float = 1e-12
    compute_dtype: str = "float32"


def _layer(x: torch.Tensor, p: dict, mask_bias: torch.Tensor | None, cfg: ElectraConfig) -> torch.Tensor:
    """One post-LN BERT/ELECTRA encoder layer (HF ElectraLayer semantics)."""
    cd = DTYPES[cfg.compute_dtype]
    h, nh = cfg.hidden, cfg.heads
    d = h // nh
    B, L, _ = x.shape

    def dense(z, w, b):  # HF Linear y = z @ w.T + b; the converter pre-transposes
        return (z.to(cd) @ w.to(cd)) + b

    q = dense(x, p["q_w"], p["q_b"]).reshape(B, L, nh, d).transpose(1, 2)
    k = dense(x, p["k_w"], p["k_b"]).reshape(B, L, nh, d).transpose(1, 2)
    v = dense(x, p["v_w"], p["v_b"]).reshape(B, L, nh, d).transpose(1, 2)
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
    if mask_bias is not None:
        s = s + mask_bias  # (B, 1, 1, L): -1e30 on padded keys
    a = torch.softmax(s, dim=-1).to(cd)
    ctx = (a.float() @ v.float()).to(cd).transpose(1, 2).reshape(B, L, h)
    x = _ln(x + dense(ctx, p["ao_w"], p["ao_b"]), p["aln_g"], p["aln_b"], cfg.layer_norm_eps)
    inter = F.gelu(dense(x, p["i_w"], p["i_b"]), approximate="none")
    return _ln(x + dense(inter, p["o_w"], p["o_b"]), p["oln_g"], p["oln_b"], cfg.layer_norm_eps)


@torch.no_grad()
def forward(
    params: dict,
    cfg: ElectraConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    token_type_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Token ids ``(B, L)`` on the params' device -> the last hidden state
    ``(B, L, hidden)`` in float32, as HF ``ElectraModel(...).last_hidden_state``
    in eval mode (no dropout). ``attention_mask``: 1 for real tokens, 0 for
    padding."""
    B, L = input_ids.shape
    emb = params["word_emb"][input_ids]
    emb = emb + params["pos_emb"][:L][None]
    tt = torch.zeros_like(input_ids) if token_type_ids is None else token_type_ids
    emb = emb + params["type_emb"][tt]
    emb = _ln(emb, params["emb_ln_g"], params["emb_ln_b"], cfg.layer_norm_eps)
    if "emb_proj_w" in params:  # electra-small: embedding_size != hidden
        emb = emb @ params["emb_proj_w"] + params["emb_proj_b"]
    x = emb.to(DTYPES[cfg.compute_dtype])
    mask_bias = None
    if attention_mask is not None:
        mask_bias = torch.where(attention_mask[:, None, None, :].bool(), 0.0, -1e30).float()
    layers = params["layers"]
    for i in range(cfg.layers):
        x = _layer(x, {k: v[i] for k, v in layers.items()}, mask_bias, cfg)
    return x.float()


def cls_embeddings(
    params: dict,
    cfg: ElectraConfig,
    input_ids: np.ndarray,
    attention_mask: np.ndarray | None = None,
    *,
    batch_size: int = 16,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Token ids -> ``(B, 1, hidden)`` float32 CLS embeddings (the reference's
    text embedding contract), ``batch_size`` sequences a forward, on
    ``device`` (without CUDA pass ``device="cpu"``)."""
    device = resolve_device(device)
    params = params_to(params, device)
    ids = torch.from_numpy(np.asarray(input_ids, np.int64))
    mask = torch.ones_like(ids) if attention_mask is None else torch.from_numpy(
        np.asarray(attention_mask, np.int64))
    outs = []
    for i in range(0, len(ids), batch_size):
        sl = slice(i, i + batch_size)
        h = forward(params, cfg, ids[sl].to(device), mask[sl].to(device))
        outs.append(h[:, 0].cpu().numpy())
    return np.concatenate(outs)[:, None, :].astype(np.float32)


# --- HF checkpoint conversion ------------------------------------------------


def convert_hf_state_dict(sd: dict[str, Any], cfg: ElectraConfig) -> dict:
    """HF ``ElectraModel`` state dict -> params dict of float32 CPU tensors
    (takes tensors or arrays; keys with or without the ``electra.`` prefix)."""

    def a(name):
        for k in (name, "electra." + name):
            if k in sd:
                v = sd[k].detach().cpu().numpy() if hasattr(sd[k], "detach") else sd[k]
                return torch.as_tensor(np.asarray(v, dtype=np.float32))
        raise KeyError(name)

    params: dict[str, Any] = {
        "word_emb": a("embeddings.word_embeddings.weight"),
        "pos_emb": a("embeddings.position_embeddings.weight"),
        "type_emb": a("embeddings.token_type_embeddings.weight"),
        "emb_ln_g": a("embeddings.LayerNorm.weight"),
        "emb_ln_b": a("embeddings.LayerNorm.bias"),
    }
    if any("embeddings_project" in k for k in sd):
        params["emb_proj_w"] = a("embeddings_project.weight").T.contiguous()
        params["emb_proj_b"] = a("embeddings_project.bias")

    # HF Linear stores (out, in): the weights are pre-transposed to (in, out)
    names = {
        "q": "attention.self.query", "k": "attention.self.key", "v": "attention.self.value",
        "ao": "attention.output.dense", "i": "intermediate.dense", "o": "output.dense",
    }
    norms = {"aln": "attention.output.LayerNorm", "oln": "output.LayerNorm"}
    layers: dict[str, list] = {}
    for i in range(cfg.layers):
        pre = f"encoder.layer.{i}."
        for key, hf in names.items():
            layers.setdefault(f"{key}_w", []).append(a(pre + hf + ".weight").T)
            layers.setdefault(f"{key}_b", []).append(a(pre + hf + ".bias"))
        for key, hf in norms.items():
            layers.setdefault(f"{key}_g", []).append(a(pre + hf + ".weight"))
            layers.setdefault(f"{key}_b", []).append(a(pre + hf + ".bias"))
    params["layers"] = {k: torch.stack(v).contiguous() for k, v in layers.items()}
    return params


def init_params(gen: torch.Generator, cfg: ElectraConfig) -> dict:
    """Random init on the CPU from ``gen`` (testing and timing without
    weights): N(0, 0.02²) embeddings and weights, zero biases, unit norms.
    The numbers differ from the JAX package's `init_params` for the same
    seed; `electra_params_from_jax` carries JAX weights over."""
    h, e, n, L = cfg.hidden, cfg.embedding_size, cfg.intermediate, cfg.layers

    def nrm(*shape):
        return 0.02 * torch.randn(shape, generator=gen)

    params = {
        "word_emb": nrm(cfg.vocab_size, e),
        "pos_emb": nrm(cfg.max_position, e),
        "type_emb": nrm(cfg.type_vocab, e),
        "emb_ln_g": torch.ones(e),
        "emb_ln_b": torch.zeros(e),
    }
    if e != h:
        params["emb_proj_w"] = nrm(e, h)
        params["emb_proj_b"] = torch.zeros(h)
    params["layers"] = {
        "q_w": nrm(L, h, h), "q_b": torch.zeros(L, h),
        "k_w": nrm(L, h, h), "k_b": torch.zeros(L, h),
        "v_w": nrm(L, h, h), "v_b": torch.zeros(L, h),
        "ao_w": nrm(L, h, h), "ao_b": torch.zeros(L, h),
        "aln_g": torch.ones(L, h), "aln_b": torch.zeros(L, h),
        "i_w": nrm(L, h, n), "i_b": torch.zeros(L, n),
        "o_w": nrm(L, n, h), "o_b": torch.zeros(L, h),
        "oln_g": torch.ones(L, h), "oln_b": torch.zeros(L, h),
    }
    return params


def electra_params_from_jax(tree: dict, device: str | torch.device = "cpu") -> dict:
    """The JAX package's ELECTRA params (numpy leaves, ``jax.device_get``) as
    a params dict: the layouts are shared, so this is a leaf-wise copy."""
    return params_from_jax(tree, device)
