"""Model loading and saving.

Three sources of weights (a classifier's, or a regressor's with its
bar-distribution borders, ``criterion.borders``):
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
    # the FullSupportBarDistribution borders of a regression model, else None
    criterion_borders: np.ndarray | None = None


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
# ... and regressor (`max_num_classes` 0, 5000 bars; the JAX package's
# `default_model_config("regressor")`), whose random init takes the borders
# ``linspace(-12, 12, 5001)`` (its `estimator/base.py:76-90`)
DEFAULT_REGRESSOR_CONFIG = DEFAULT_CLASSIFIER_CONFIG | {"max_num_classes": 0, "num_buckets": 5000}


def load_model(
    path: str | Path,
    *,
    model_seed: int = 0,
    mixer_type: str = "none",
    mgm_heads: int = 8,
    cap_heads: int = 8,
    features_per_group: int | None = None,
    device: torch.device | str = "cpu",
    which: str = "classifier",
) -> LoadedModel:
    """Load weights from a reference checkpoint, ``"random[:<seed>]"`` (the
    published ``which`` architecture: "classifier" or "regressor") or an
    ``.npz`` written by `save_npz`; the params land on ``device``. A
    regression checkpoint (``max_num_classes`` 0) gives its
    ``criterion.borders`` to ``criterion_borders`` and has ``n_out`` one less
    than their count (the JAX package's `loading.py:55-91`)."""
    mixer = MixerConfig(mixer_type=mixer_type, mgm_heads=mgm_heads, cap_heads=cap_heads)
    if isinstance(path, str) and path.startswith("random"):
        seed = int(path.split(":", 1)[1]) if ":" in path else model_seed
        regressor = which == "regressor"
        cfg = ModelConfig.from_ckpt_config(
            DEFAULT_REGRESSOR_CONFIG if regressor else DEFAULT_CLASSIFIER_CONFIG,
            features_per_group=features_per_group,
            mixer=mixer,
            model_seed=seed,
        )
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seed)
        borders = np.linspace(-12.0, 12.0, cfg.n_out + 1) if regressor else None
        return LoadedModel(params=init_params(gen, cfg, device=device), config=cfg,
                           criterion_borders=borders)
    if str(path).endswith(".npz"):
        return load_npz(path, device=device)

    ckpt = torch.load(Path(path), map_location="cpu", weights_only=False)
    assert "state_dict" in ckpt and "config" in ckpt, "unrecognized checkpoint format"
    state_dict = dict(ckpt["state_dict"])
    ckpt_config = dict(ckpt["config"])
    criterion_borders = None
    if ckpt_config.get("max_num_classes", 10) == 0:
        borders = state_dict.pop("criterion.borders", None)
        for k in [k for k in state_dict if "criterion." in k]:
            state_dict.pop(k)
        if borders is not None:
            criterion_borders = np.asarray(borders)
    cfg = ModelConfig.from_ckpt_config(
        ckpt_config, features_per_group=features_per_group, mixer=mixer,
        n_out=None if criterion_borders is None else len(criterion_borders) - 1,
        model_seed=model_seed,
    )
    params = convert_reference_state_dict(state_dict, cfg, model_seed=model_seed, device=device)
    return LoadedModel(params=params, config=cfg, ckpt_config=ckpt_config,
                       criterion_borders=criterion_borders)


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


def save_model(path: str | Path, params: dict, cfg: ModelConfig, *, ckpt_config: dict | None = None,
               criterion_borders: np.ndarray | None = None) -> None:
    """Save in the reference's torch checkpoint format (`loading.py:546-567`;
    the JAX package's `save_model`): ``{"state_dict", "config"}`` with the
    mixer's weights when the params have them, and a regressor's borders as
    ``criterion.borders``."""
    state = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in export_reference_state_dict(params, cfg).items()}
    if criterion_borders is not None:
        state["criterion.borders"] = torch.from_numpy(np.asarray(criterion_borders))
    torch.save({"state_dict": state, "config": model_config_to_ckpt_config(cfg, ckpt_config)}, Path(path))


def save_npz(path: str | Path, params: dict, cfg: ModelConfig,
             criterion_borders: np.ndarray | None = None) -> None:
    """Write a param tree (numpy leaves, e.g. ``jax.device_get`` of the JAX
    package's params, or tensors), its config and a regressor's borders to
    one ``.npz``."""
    flat = {
        "params/" + k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
        for k, v in flatten_params(params).items()
    }
    if criterion_borders is not None:
        flat["criterion_borders"] = np.asarray(criterion_borders)
    cfg_json = json.dumps(dataclasses.asdict(cfg))
    np.savez(Path(path), config=np.asarray(cfg_json), **flat)


def load_npz(path: str | Path, device: torch.device | str = "cpu") -> LoadedModel:
    """Inverse of `save_npz`."""
    with np.load(Path(path), allow_pickle=False) as data:
        cfg_dict = json.loads(str(data["config"]))
        flat = {k[len("params/"):]: data[k] for k in data.files if k.startswith("params/")}
        borders = data["criterion_borders"] if "criterion_borders" in data.files else None
    mixer = MixerConfig(**cfg_dict.pop("mixer"))
    cfg = ModelConfig(mixer=mixer, **cfg_dict)
    params = params_from_jax(unflatten_params(flat), device=device)
    return LoadedModel(params=params, config=cfg, criterion_borders=borders)

