"""Model loading and saving.

Three sources of classifier weights:
  * a reference-format torch checkpoint ``{"state_dict": ..., "config": ...}``
    (`mmpfn/models/mmpfn/model/loading.py:401-543`), converted by
    `convert_reference_state_dict`;
  * ``"random"`` / ``"random:<seed>"``: a fresh init of the published
    architecture from a seeded ``torch.Generator``;
  * an ``.npz`` of numpy params plus the model config (`save_npz`), which is how
    the JAX package's weights reach this package (`params_from_jax`).

`save_model` writes the reference torch format (what fine-tuning saves), the
inverse of `convert_reference_state_dict`, so `load_model` reads it back.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from multimodalpfn_tpu_torch.models.config import MixerConfig, ModelConfig
from multimodalpfn_tpu_torch.models.params import (
    convert_reference_state_dict,
    export_reference_state_dict,
    flatten_params,
    init_params,
    params_from_jax,
    unflatten_params,
)


@dataclasses.dataclass
class LoadedModel:
    params: dict
    config: ModelConfig
    ckpt_config: dict | None = None  # a reference checkpoint's config dict


# The published TabPFN-v2 classifier architecture (reference
# `model/config.py:25-84`, `loading.py:492-495`).
DEFAULT_CLASSIFIER_CONFIG = {
    "emsize": 192,
    "nhead": 6,
    "nhid_factor": 4,
    "nlayers": 12,
    "features_per_group": 1,
    "max_num_classes": 10,
    "num_buckets": 1000,
    "seq_len": 2000,
    "max_num_features": 85,
    "remove_duplicate_features": False,
}


def load_model(
    path: str | Path,
    *,
    model_seed: int = 0,
    mixer_type: str = "none",
    mgm_heads: int = 8,
    cap_heads: int = 8,
    features_per_group: int | None = None,
    device: torch.device | str = "cpu",
) -> LoadedModel:
    """Load weights from a reference checkpoint, ``"random[:<seed>]"`` or an
    ``.npz`` written by `save_npz`; the params land on ``device``."""
    mixer = MixerConfig(mixer_type=mixer_type, mgm_heads=mgm_heads, cap_heads=cap_heads)
    if isinstance(path, str) and path.startswith("random"):
        seed = int(path.split(":", 1)[1]) if ":" in path else model_seed
        cfg = ModelConfig.from_ckpt_config(
            DEFAULT_CLASSIFIER_CONFIG,
            features_per_group=features_per_group,
            mixer=mixer,
            model_seed=seed,
        )
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seed)
        return LoadedModel(params=init_params(gen, cfg, device=device), config=cfg)
    if str(path).endswith(".npz"):
        return load_npz(path, device=device)

    ckpt = torch.load(Path(path), map_location="cpu", weights_only=False)
    assert "state_dict" in ckpt and "config" in ckpt, "unrecognized checkpoint format"
    ckpt_config = dict(ckpt["config"])
    if ckpt_config.get("max_num_classes", 10) == 0:
        raise NotImplementedError("regression checkpoints are not ported yet")
    cfg = ModelConfig.from_ckpt_config(
        ckpt_config, features_per_group=features_per_group, mixer=mixer, model_seed=model_seed
    )
    params = convert_reference_state_dict(
        ckpt["state_dict"], cfg, model_seed=model_seed, device=device
    )
    return LoadedModel(params=params, config=cfg, ckpt_config=ckpt_config)


def model_config_to_ckpt_config(cfg: ModelConfig, base: dict | None = None) -> dict:
    """A reference-compatible ``config`` dict (fields of `model/config.py:19-84`;
    the JAX package's `model_config_to_ckpt_config`). ``base``, the dict of
    the checkpoint the model came from, is passed through, so training-era
    fields survive."""
    out = dict(base) if base else {}
    out.update(
        {
            "emsize": cfg.emsize,
            "nhead": cfg.nhead,
            "nhid_factor": cfg.nhid_factor,
            "nlayers": cfg.nlayers,
            "features_per_group": cfg.features_per_group,
            "max_num_classes": cfg.max_num_classes,
            "remove_duplicate_features": cfg.remove_duplicate_features,
            "remove_empty_features": cfg.remove_empty_features,
            "nan_handling_enabled": cfg.nan_handling_enabled,
            "nan_handling_y_encoder": cfg.nan_handling_y_encoder,
            "normalize_on_train_only": cfg.normalize_on_train_only,
            "normalize_x": cfg.normalize_x,
            "remove_outliers": False,
            "normalize_by_used_features": cfg.normalize_by_used_features,
            "encoder_use_bias": cfg.encoder_use_bias,
            "feature_positional_embedding": (
                None if cfg.feature_positional_embedding == "none" else cfg.feature_positional_embedding
            ),
            "multiquery_item_attention": False,
            "multiquery_item_attention_for_test_set": cfg.multiquery_item_attention_for_test_set,
            "seq_len": cfg.seq_len,
            "max_num_features": cfg.max_num_features,
            "num_buckets": cfg.num_buckets,
            "use_separate_decoder": False,
            "recompute_attn": False,
            "recompute_layer": True,
            "batch_size": out.get("batch_size", 8),
            "aggregate_k_gradients": out.get("aggregate_k_gradients", 1),
            "task_type": "multiclass" if cfg.max_num_classes > 0 else "regression",
            "adaptive_max_seq_len_to_max_full_table_size": out.get(
                "adaptive_max_seq_len_to_max_full_table_size", 75000
            ),
            "two_sets_of_queries": False,
        }
    )
    return out


def save_model(path: str | Path, params: dict, cfg: ModelConfig, *, ckpt_config: dict | None = None) -> None:
    """Save in the reference's torch checkpoint format (`loading.py:546-567`;
    the JAX package's `save_model`): ``{"state_dict", "config"}`` with the
    mixer's weights when the params have them."""
    state = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in export_reference_state_dict(params, cfg).items()}
    torch.save({"state_dict": state, "config": model_config_to_ckpt_config(cfg, ckpt_config)}, Path(path))


def save_npz(path: str | Path, params: dict, cfg: ModelConfig) -> None:
    """Write a param tree (numpy leaves, e.g. ``jax.device_get`` of the JAX
    package's params, or tensors) and its config to one ``.npz``."""
    flat = {
        "params/" + k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
        for k, v in flatten_params(params).items()
    }
    cfg_json = json.dumps(dataclasses.asdict(cfg))
    np.savez(Path(path), config=np.asarray(cfg_json), **flat)


def load_npz(path: str | Path, device: torch.device | str = "cpu") -> LoadedModel:
    """Inverse of `save_npz`."""
    with np.load(Path(path), allow_pickle=False) as data:
        cfg_dict = json.loads(str(data["config"]))
        flat = {k[len("params/"):]: data[k] for k in data.files if k.startswith("params/")}
    mixer = MixerConfig(**cfg_dict.pop("mixer"))
    cfg = ModelConfig(mixer=mixer, **cfg_dict)
    params = params_from_jax(unflatten_params(flat), device=device)
    return LoadedModel(params=params, config=cfg)

