"""Model loading and saving.

Three sources of classifier weights:
  * a reference-format torch checkpoint ``{"state_dict": ..., "config": ...}``
    (`mmpfn/models/mmpfn/model/loading.py:401-543`), converted by
    `convert_reference_state_dict`;
  * ``"random"`` / ``"random:<seed>"``: a fresh init of the published
    architecture from a seeded ``torch.Generator``;
  * an ``.npz`` of numpy params plus the model config (`save_npz`), which is how
    the JAX package's weights reach this package (`params_from_jax`).
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
    flatten_params,
    init_params,
    params_from_jax,
    unflatten_params,
)


@dataclasses.dataclass
class LoadedModel:
    params: dict
    config: ModelConfig


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
    return LoadedModel(params=params, config=cfg)


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

