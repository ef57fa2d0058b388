"""Parameter trees: initialization, reference-checkpoint conversion, and the
bridge from the JAX package's numpy param trees.

The param tree is a plain nested dict of tensors with the JAX package's layout
(`multimodalpfn_tpu/models/params.py`), so the two packages can be fed the same
weights and compared leaf by leaf:
  * attention keeps the reference's stacked layouts ``w_qkv (3, h, d_k, in)`` and
    ``w_out (h, d_v, out)`` (reference `multi_head_attention.py:120-147`);
  * all plain linears are stored transposed, ``(in, out)``, so application is
    ``x @ w + b``;
  * transformer layers are stacked on a leading ``L`` axis.
"""

from __future__ import annotations

import functools
import math
import re
from typing import Any, Mapping

import numpy as np
import torch

from multimodalpfn_tpu_torch.models.config import MixerConfig, ModelConfig

Params = dict


# ---------------------------------------------------------------------------
# subspace positional-embedding noise table
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1024)
def _subspace_noise_cpu(model_seed: int, n_tokens: int, sub_dim: int) -> torch.Tensor:
    gen = torch.Generator(device="cpu")
    if model_seed:
        gen.manual_seed(int(model_seed))
    # else: the reference's `if self.seed:` guard (`transformer.py:423`) treats
    # seed=0 as falsy, leaving the generator at torch's deterministic default
    # seed (67280421310721) — reproduced by not seeding.
    return torch.randn((n_tokens, sub_dim), generator=gen)


def get_subspace_noise(
    model_seed: int, n_tokens: int, sub_dim: int, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """The torch ``randn`` draws of the reference's "subspace" feature
    positional embedding (`transformer.py:925-933`).

    The reference re-seeds a generator with ``model_seed`` on every forward and
    draws ``randn(f, emsize//4)``: a constant per (seed, shape). The draw is
    always made with the CPU generator and moved to ``device`` afterwards: a
    CUDA generator gives other numbers, and with them other predictions. CPU
    draws are not prefix-stable across shapes, so the exact shape is drawn.
    """
    return _subspace_noise_cpu(int(model_seed), int(n_tokens), int(sub_dim)).to(device)


# ---------------------------------------------------------------------------
# fresh initialization (the reference's torch init distributions)
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def _attn_input_weight(gen, dims, nhead, input_size, gain=1.0):
    # reference `multi_head_attention.py:149-162`
    d = dims[-2]
    std = math.sqrt(2.0 / float(nhead * d + input_size)) * gain
    return _uniform(gen, dims, math.sqrt(3.0) * std)


def _linear_weight(gen, fan_in, fan_out, lead=()):
    """torch nn.Linear default (kaiming_uniform a=sqrt(5)) in (in, out) layout."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return _uniform(gen, (*lead, fan_in, fan_out), bound)


def _linear_bias(gen, fan_in, fan_out, lead=()):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return _uniform(gen, (*lead, fan_out), bound)


def _xavier_uniform(gen, shape, gain=1.0):
    fan_in, fan_out = shape[-1], shape[-2]
    return _uniform(gen, shape, gain * math.sqrt(6.0 / (fan_in + fan_out)))


def init_mixer_params(gen: torch.Generator, cfg: MixerConfig, emsize: int) -> Params:
    """Initialize mixer params from scratch (these are never in the base ckpt)."""
    p: Params = {}
    in_dim = cfg.in_dim
    if cfg.mixer_type in ("MGM", "MGM+CAP"):
        h = cfg.mgm_heads
        # stacked over heads; reference `transformer.py:33-48` per-head Sequential
        p["mgm"] = {
            "ln_g": torch.ones((h, in_dim)),
            "ln_b": torch.zeros((h, in_dim)),
            "w1": _linear_weight(gen, in_dim, in_dim, (h,)),
            "b1": _linear_bias(gen, in_dim, in_dim, (h,)),
            "w2": _linear_weight(gen, in_dim // 2, emsize, (h,)),
            "b2": _linear_bias(gen, in_dim // 2, emsize, (h,)),
        }
    if cfg.mixer_type == "MGM+CAP":
        ch, e = cfg.cap_heads, emsize
        # reference `transformer.py:60-88`
        p["cap"] = {
            "queries": 1e-2 * torch.randn((ch, e), generator=gen),
            "q_proj_w": _linear_weight(gen, e, e),
            "in_proj_w": _xavier_uniform(gen, (3 * e, e)),  # torch MHA layout
            "in_proj_b": torch.zeros((3 * e,)),
            "out_proj_w": _linear_weight(gen, e, e).T.contiguous(),  # (out, in)
            "out_proj_b": torch.zeros((e,)),
            "k_norm_g": torch.ones((e,)),
            "k_norm_b": torch.zeros((e,)),
            "q_norm_g": torch.ones((e,)),
            "q_norm_b": torch.zeros((e,)),
            "out_norm_g": torch.ones((e,)),
            "out_norm_b": torch.zeros((e,)),
            "ffn_w1": _linear_weight(gen, e, 2 * e),
            "ffn_b1": _linear_bias(gen, e, 2 * e),
            "ffn_w2": _linear_weight(gen, 2 * e, e),
            "ffn_b2": _linear_bias(gen, 2 * e, e),
        }
    if cfg.mixer_type == "MoE":
        n = cfg.mgm_heads  # n_experts = mgm_heads (reference `transformer.py:301`)
        # reference `transformer.py:91-106`
        p["moe"] = {
            "ln_g": torch.ones((n, in_dim)),
            "ln_b": torch.zeros((n, in_dim)),
            "w1": _linear_weight(gen, in_dim, in_dim // 2, (n,)),
            "b1": _linear_bias(gen, in_dim, in_dim // 2, (n,)),
            "w2": _linear_weight(gen, in_dim // 2, emsize, (n,)),
            "b2": _linear_bias(gen, in_dim // 2, emsize, (n,)),
            "gate_w": _linear_weight(gen, in_dim, n),
            "gate_b": _linear_bias(gen, in_dim, n),
        }
    return p


# leaf -> axis that stacks heads/experts (everything else is shape-invariant)
_MGM_HEAD_AXIS = {"ln_g": 0, "ln_b": 0, "w1": 0, "b1": 0, "w2": 0, "b2": 0}
_MOE_EXPERT_AXIS = {
    "ln_g": 0, "ln_b": 0, "w1": 0, "b1": 0, "w2": 0, "b2": 0,
    "gate_w": 1, "gate_b": 0,
}


def _pad_leaf(x: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    if x.shape[axis] == to:
        return x
    shape = list(x.shape)
    shape[axis] = to - x.shape[axis]
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def pad_mixer_params(p: Params, cfg_pad: MixerConfig) -> Params:
    """Zero-pad the per-head MGM leaves and per-expert MoE leaves up to
    ``cfg_pad.mgm_heads`` (the JAX package's `pad_mixer_params`). With the
    activation mask of ``apply_mixer(mgm_active=...)`` the padded mixer
    computes what the unpadded one of the active size does, and its padded
    leaves get zero gradients: grid cells with different ``mgm_heads`` share
    one sweep. CAP is never padded (``cap_heads`` sets its head split)."""
    out = dict(p)
    if "mgm" in p:
        out["mgm"] = {k: _pad_leaf(v, _MGM_HEAD_AXIS[k], cfg_pad.mgm_heads) for k, v in p["mgm"].items()}
    if "moe" in p:
        out["moe"] = {k: _pad_leaf(v, _MOE_EXPERT_AXIS[k], cfg_pad.mgm_heads) for k, v in p["moe"].items()}
    return out


def slice_mixer_params(p: Params, cfg_active: MixerConfig) -> Params:
    """Inverse of `pad_mixer_params`: the active prefix, so that a padded
    run's result is a checkpoint of its cell's true shape."""
    out = dict(p)
    for name, axes in (("mgm", _MGM_HEAD_AXIS), ("moe", _MOE_EXPERT_AXIS)):
        if name in p:
            out[name] = {k: v.narrow(axes[k], 0, cfg_active.mgm_heads) for k, v in p[name].items()}
    return out


def init_params(
    gen: torch.Generator, cfg: ModelConfig, device: torch.device | str = "cpu"
) -> Params:
    """Fresh random init of the whole model with the reference's distributions:
    zero-init output projections (`layer.py:192,232`), attention input init
    (`multi_head_attention.py:149-162`), torch Linear defaults elsewhere.

    Draws come from ``gen`` (a CPU generator) and the tree is moved to
    ``device`` afterwards. The numbers differ from the JAX package's
    `init_params` for the same seed; `params_from_jax` carries JAX weights over
    where the two must agree."""
    e, h, d, L, nhid = cfg.emsize, cfg.nhead, cfg.d_head, cfg.nlayers, cfg.nhid
    fpg = cfg.features_per_group
    params: Params = {
        "encoder": {"w": _linear_weight(gen, 2 * fpg, e)},
        "y_encoder": {"w": _linear_weight(gen, 2, e), "b": _linear_bias(gen, 2, e)},
        "layers": {
            "attn_feat": {
                "w_qkv": _attn_input_weight(gen, (L, 3, h, d, e), h, e),
                "w_out": torch.zeros((L, h, d, e)),
            },
            "attn_item": {
                "w_qkv": _attn_input_weight(gen, (L, 3, h, d, e), h, e),
                "w_out": torch.zeros((L, h, d, e)),
            },
            "mlp": {
                "w1": _linear_weight(gen, e, nhid, (L,)),
                "w2": torch.zeros((L, nhid, e)),
            },
        },
        "decoder": {
            "w1": _linear_weight(gen, e, nhid),
            "b1": _linear_bias(gen, e, nhid),
            "w2": _linear_weight(gen, nhid, cfg.n_out),
            "b2": _linear_bias(gen, nhid, cfg.n_out),
        },
    }
    if cfg.feature_positional_embedding == "subspace":
        params["feat_pos_emb"] = {
            "w": _linear_weight(gen, e // 4, e),
            "b": _linear_bias(gen, e // 4, e),
        }
    mixer = init_mixer_params(gen, cfg.mixer, e)
    if mixer:
        params["mixer"] = mixer
    return params_to(params, device)


# ---------------------------------------------------------------------------
# tree helpers and the bridge from the JAX package
# ---------------------------------------------------------------------------


def tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_to(params: Params, device=None, dtype=None) -> Params:
    """Move (and optionally cast) every leaf."""
    return tree_map(lambda t: t.to(device=device, dtype=dtype), params)


def params_from_jax(tree: Mapping, device: torch.device | str = "cpu") -> Params:
    """Tensor tree from the JAX package's param tree, given as numpy leaves
    (``jax.device_get(params)``). The layouts are shared, so this is a leaf-wise
    copy; both packages then compute with the same weights."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device),
        tree,
    )


def params_to_numpy(params: Params) -> dict:
    """Inverse of `params_from_jax`: a tree of float32 numpy leaves."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def flatten_params(tree: Mapping, prefix: str = "") -> dict:
    """``{"layers/mlp/w1": leaf, ...}`` (the `.npz` key layout)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_params(v, key + "/"))
        else:
            out[key] = v
    return out


def unflatten_params(flat: Mapping) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


# ---------------------------------------------------------------------------
# reference checkpoint conversion
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def convert_reference_state_dict(
    state_dict: Mapping[str, Any],
    cfg: ModelConfig,
    *,
    model_seed: int = 0,
    device: torch.device | str = "cpu",
) -> Params:
    """Map a reference torch ``state_dict`` onto the param tree (the counterpart
    of the JAX package's `convert_torch_state_dict`).

    Name anchors (reference modules):
      * ``encoder.<i>.layer.weight`` — `encoders.py:382-425` LinearInputEncoderStep
      * ``y_encoder.<i>.layer.{weight,bias}``
      * ``transformer_encoder.layers.<l>.self_attn_between_{features,items}._w_{qkv,out}``
      * ``transformer_encoder.layers.<l>.mlp.linear{1,2}.weight``
      * ``decoder_dict.standard.{0,2}.{weight,bias}``
      * ``feature_positional_embedding_embeddings.{weight,bias}``
      * mixer weights ``mgm.projs.*`` / ``cap.*`` / ``moe.*`` when present; absent
        mixer weights are freshly initialized from ``model_seed`` (the
        reference's ``load_state_dict(strict=False)``, `loading.py:540`).
    """
    sd = {k: _np(v) for k, v in state_dict.items()}
    L = cfg.nlayers

    def find_one(pattern: str) -> np.ndarray:
        hits = [k for k in sd if re.fullmatch(pattern, k)]
        if len(hits) != 1:
            raise KeyError(f"expected exactly one key for {pattern}, got {hits}")
        return sd[hits[0]]

    def layer_stack(fmt: str) -> np.ndarray:
        return np.stack([sd[fmt.format(l=l)] for l in range(L)])

    enc_w = find_one(r"encoder\.\d+\.layer\.weight")
    if enc_w.shape[1] != 2 * cfg.features_per_group:
        raise ValueError(
            f"features_per_group={cfg.features_per_group} is inconsistent with the "
            f"checkpoint's input encoder (expects {enc_w.shape[1] // 2}); the "
            "reference's strict=False load would fail on this shape mismatch too "
            "(`loading.py:540`). Pass the checkpoint's features_per_group."
        )
    pre = "transformer_encoder.layers.{l}"
    params: Params = {
        "encoder": {"w": _t(enc_w.T)},
        "y_encoder": {
            "w": _t(find_one(r"y_encoder\.\d+\.layer\.weight").T),
            "b": _t(find_one(r"y_encoder\.\d+\.layer\.bias")),
        },
        "layers": {
            "attn_feat": {
                "w_qkv": _t(layer_stack(pre + ".self_attn_between_features._w_qkv")),
                "w_out": _t(layer_stack(pre + ".self_attn_between_features._w_out")),
            },
            "attn_item": {
                "w_qkv": _t(layer_stack(pre + ".self_attn_between_items._w_qkv")),
                "w_out": _t(layer_stack(pre + ".self_attn_between_items._w_out")),
            },
            "mlp": {
                "w1": _t(np.swapaxes(layer_stack(pre + ".mlp.linear1.weight"), -1, -2)),
                "w2": _t(np.swapaxes(layer_stack(pre + ".mlp.linear2.weight"), -1, -2)),
            },
        },
        "decoder": {
            "w1": _t(sd["decoder_dict.standard.0.weight"].T),
            "b1": _t(sd["decoder_dict.standard.0.bias"]),
            "w2": _t(sd["decoder_dict.standard.2.weight"].T),
            "b2": _t(sd["decoder_dict.standard.2.bias"]),
        },
    }
    if cfg.feature_positional_embedding == "subspace":
        params["feat_pos_emb"] = {
            "w": _t(sd["feature_positional_embedding_embeddings.weight"].T),
            "b": _t(sd["feature_positional_embedding_embeddings.bias"]),
        }
    mixer_params = _convert_mixer(sd, cfg.mixer)
    if mixer_params is None and cfg.mixer.mixer_type != "none":
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(model_seed))
        mixer_params = init_mixer_params(gen, cfg.mixer, cfg.emsize)
    if mixer_params:
        params["mixer"] = mixer_params
    return params_to(params, device)


def _convert_mixer(sd: dict[str, np.ndarray], cfg: MixerConfig) -> Params | None:
    if cfg.mixer_type == "none":
        return None

    def heads(fmt: str, n: int, transpose: bool = False) -> torch.Tensor:
        return _t(np.stack([sd[fmt.format(i=i)].T if transpose else sd[fmt.format(i=i)]
                            for i in range(n)]))

    p: Params = {}
    if "mgm.projs.0.1.weight" in sd:
        h = cfg.mgm_heads
        p["mgm"] = {
            "ln_g": heads("mgm.projs.{i}.0.weight", h),
            "ln_b": heads("mgm.projs.{i}.0.bias", h),
            "w1": heads("mgm.projs.{i}.1.weight", h, transpose=True),
            "b1": heads("mgm.projs.{i}.1.bias", h),
            "w2": heads("mgm.projs.{i}.4.weight", h, transpose=True),
            "b2": heads("mgm.projs.{i}.4.bias", h),
        }
    if "cap.queries" in sd:
        p["cap"] = {
            "queries": _t(sd["cap.queries"]),
            "q_proj_w": _t(sd["cap.q_proj.weight"].T),
            "in_proj_w": _t(sd["cap.mha.in_proj_weight"]),
            "in_proj_b": _t(sd["cap.mha.in_proj_bias"]),
            "out_proj_w": _t(sd["cap.mha.out_proj.weight"]),
            "out_proj_b": _t(sd["cap.mha.out_proj.bias"]),
            "k_norm_g": _t(sd["cap.k_norm.weight"]),
            "k_norm_b": _t(sd["cap.k_norm.bias"]),
            "q_norm_g": _t(sd["cap.q_norm.weight"]),
            "q_norm_b": _t(sd["cap.q_norm.bias"]),
            "out_norm_g": _t(sd["cap.out_norm.weight"]),
            "out_norm_b": _t(sd["cap.out_norm.bias"]),
            "ffn_w1": _t(sd["cap.ffn.0.weight"].T),
            "ffn_b1": _t(sd["cap.ffn.0.bias"]),
            "ffn_w2": _t(sd["cap.ffn.3.weight"].T),
            "ffn_b2": _t(sd["cap.ffn.3.bias"]),
        }
    if "moe.gate.weight" in sd:
        n = cfg.mgm_heads
        p["moe"] = {
            "ln_g": heads("moe.experts.{i}.0.weight", n),
            "ln_b": heads("moe.experts.{i}.0.bias", n),
            "w1": heads("moe.experts.{i}.1.weight", n, transpose=True),
            "b1": heads("moe.experts.{i}.1.bias", n),
            "w2": heads("moe.experts.{i}.4.weight", n, transpose=True),
            "b2": heads("moe.experts.{i}.4.bias", n),
            "gate_w": _t(sd["moe.gate.weight"].T),
            "gate_b": _t(sd["moe.gate.bias"]),
        }
    return p or None


def export_reference_state_dict(params: Params, cfg: ModelConfig) -> dict[str, np.ndarray]:
    """Inverse of `convert_reference_state_dict` (the counterpart of the JAX
    package's `export_torch_state_dict`). Encoder step indices follow the
    reference's default encoder construction (`loading.py:308-398`)."""
    p = params_to_numpy(params)
    enc_idx = 2 + int(cfg.remove_empty_features) + int(cfg.remove_duplicate_features)
    enc_idx += 2 if cfg.nan_handling_enabled else 0
    y_idx = (1 if cfg.nan_handling_y_encoder else 0) + (
        1 if cfg.max_num_classes >= 2 else 0
    )
    out: dict[str, np.ndarray] = {
        f"encoder.{enc_idx}.layer.weight": p["encoder"]["w"].T,
        f"y_encoder.{y_idx}.layer.weight": p["y_encoder"]["w"].T,
        f"y_encoder.{y_idx}.layer.bias": p["y_encoder"]["b"],
        "decoder_dict.standard.0.weight": p["decoder"]["w1"].T,
        "decoder_dict.standard.0.bias": p["decoder"]["b1"],
        "decoder_dict.standard.2.weight": p["decoder"]["w2"].T,
        "decoder_dict.standard.2.bias": p["decoder"]["b2"],
    }
    if "feat_pos_emb" in p:
        out["feature_positional_embedding_embeddings.weight"] = p["feat_pos_emb"]["w"].T
        out["feature_positional_embedding_embeddings.bias"] = p["feat_pos_emb"]["b"]
    layers = p["layers"]
    for l in range(cfg.nlayers):
        pre = f"transformer_encoder.layers.{l}"
        out[f"{pre}.self_attn_between_features._w_qkv"] = layers["attn_feat"]["w_qkv"][l]
        out[f"{pre}.self_attn_between_features._w_out"] = layers["attn_feat"]["w_out"][l]
        out[f"{pre}.self_attn_between_items._w_qkv"] = layers["attn_item"]["w_qkv"][l]
        out[f"{pre}.self_attn_between_items._w_out"] = layers["attn_item"]["w_out"][l]
        out[f"{pre}.mlp.linear1.weight"] = layers["mlp"]["w1"][l].T
        out[f"{pre}.mlp.linear2.weight"] = layers["mlp"]["w2"][l].T
    mix = p.get("mixer", {})
    for name, n_key in (("mgm", "projs"), ("moe", "experts")):
        if name not in mix:
            continue
        m = mix[name]
        for i in range(m["ln_g"].shape[0]):
            out[f"{name}.{n_key}.{i}.0.weight"] = m["ln_g"][i]
            out[f"{name}.{n_key}.{i}.0.bias"] = m["ln_b"][i]
            out[f"{name}.{n_key}.{i}.1.weight"] = m["w1"][i].T
            out[f"{name}.{n_key}.{i}.1.bias"] = m["b1"][i]
            out[f"{name}.{n_key}.{i}.4.weight"] = m["w2"][i].T
            out[f"{name}.{n_key}.{i}.4.bias"] = m["b2"][i]
    if "moe" in mix:
        out["moe.gate.weight"] = mix["moe"]["gate_w"].T
        out["moe.gate.bias"] = mix["moe"]["gate_b"]
    if "cap" in mix:
        c = mix["cap"]
        out.update(
            {
                "cap.queries": c["queries"],
                "cap.q_proj.weight": c["q_proj_w"].T,
                "cap.mha.in_proj_weight": c["in_proj_w"],
                "cap.mha.in_proj_bias": c["in_proj_b"],
                "cap.mha.out_proj.weight": c["out_proj_w"],
                "cap.mha.out_proj.bias": c["out_proj_b"],
                "cap.k_norm.weight": c["k_norm_g"],
                "cap.k_norm.bias": c["k_norm_b"],
                "cap.q_norm.weight": c["q_norm_g"],
                "cap.q_norm.bias": c["q_norm_b"],
                "cap.out_norm.weight": c["out_norm_g"],
                "cap.out_norm.bias": c["out_norm_b"],
                "cap.ffn.0.weight": c["ffn_w1"].T,
                "cap.ffn.0.bias": c["ffn_b1"],
                "cap.ffn.3.weight": c["ffn_w2"].T,
                "cap.ffn.3.bias": c["ffn_b2"],
            }
        )
    return {k: np.ascontiguousarray(v) for k, v in out.items()}
