"""Model configuration.

`ModelConfig` is the static (hashable) architecture description threaded through the
jitted forward. It merges the reference's checkpoint-frozen `InferenceConfig`
(`mmpfn/models/mmpfn/model/config.py:19-108`) with the externally-overridable knobs
(`features_per_group`, mixer selection) that `load_model` exposes
(`model/loading.py:401-538`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal


@dataclass(frozen=True)
class MixerConfig:
    """Multimodal mixer selection (reference `transformer.py:292-301`)."""

    mixer_type: Literal["MGM", "MGM+CAP", "MoE", "none"] = "none"
    mgm_heads: int = 8
    cap_heads: int = 8
    in_dim: int = 768  # frozen-encoder embedding width
    dropout: float = 0.1

    @property
    def moe_top_k(self) -> int:
        # reference `transformer.py:301`: top_k = max(mgm_heads, cap_heads), which
        # is >= n_experts (= mgm_heads) whenever cap<=mgm -> dense mixing.
        return max(self.mgm_heads, self.cap_heads)


@dataclass(frozen=True)
class ModelConfig:
    """Static architecture hyper-parameters of the PerFeatureTransformer."""

    emsize: int = 192
    nhead: int = 6
    nhid_factor: int = 4
    nlayers: int = 12
    features_per_group: int = 1
    n_out: int = 10  # max_num_classes for clf; num_bars for regression
    max_num_classes: int = 10  # 0 => regression
    feature_positional_embedding: Literal["subspace", "none"] = "subspace"
    remove_empty_features: bool = True
    remove_duplicate_features: bool = False
    nan_handling_enabled: bool = True
    nan_handling_y_encoder: bool = True
    normalize_on_train_only: bool = True
    normalize_x: bool = True
    remove_outliers: bool = False  # overridden to 12-sigma by classifier fit
    remove_outliers_sigma: float = 12.0
    normalize_by_used_features: bool = True
    encoder_use_bias: bool = False
    multiquery_item_attention_for_test_set: bool = True
    seq_len: int = 2000
    max_num_features: int = 85
    num_buckets: int = 1000
    mixer: MixerConfig = dataclasses.field(default_factory=MixerConfig)
    # compute policy: "float32" for parity, "bfloat16" for production speed
    compute_dtype: Literal["float32", "bfloat16"] = "float32"
    # seed of the per-forward feature-positional-embedding draws (reference
    # `transformer.py:413,498`); the draw is a constant per (seed, token count)
    model_seed: int = 0
    # hand-written item-attention kernel (ops/item_fused.py); the estimator
    # turns this on when running on a CUDA device
    use_flash: bool = False
    # sequence parallelism: the mesh axis over which the item attention's
    # train-row K/V are ring-sharded (parallel/ring_attention.py). Requires
    # running under parallel.mesh.set_mesh(...) with this axis present and the
    # train-row count divisible by the axis size. None = off.
    seq_shard_axis: str | None = None
    # hand-written row-local sublayer kernels (feature-attention+LN, MLP+LN,
    # ops/fused.py) and the item-major layer that runs them
    fused_ops: bool = False
    # fully-fused item-attention sublayer (ops/item_fused.py); effective only
    # when use_flash is also on and the shape qualifies — escape hatch for A/B
    # measurement
    fused_item: bool = True

    @property
    def nhid(self) -> int:
        return self.emsize * self.nhid_factor

    @property
    def d_head(self) -> int:
        return self.emsize // self.nhead

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_ckpt_config(
        cls,
        config: dict,
        *,
        features_per_group: int | None = None,
        mixer: MixerConfig | None = None,
        n_out: int | None = None,
        model_seed: int = 0,
    ) -> "ModelConfig":
        """Build from a reference checkpoint's ``config`` dict.

        Mirrors the decision tree in reference `loading.py:460-538`.
        """
        max_num_classes = int(config.get("max_num_classes", 10))
        # the reference ties the mixer input width to the transformer's nhid
        # (`transformer.py:295-301`: MultiheadGatedMLP(in_dim=nhid, ...))
        if mixer is not None:
            nhid = int(config.get("emsize", 192)) * int(config.get("nhid_factor", 4))
            mixer = dataclasses.replace(mixer, in_dim=nhid)
        if n_out is None:
            if max_num_classes == 2:
                n_out = 1
            elif max_num_classes > 2:
                n_out = max_num_classes
            else:  # regression: n_out set by caller from criterion borders
                n_out = int(config.get("num_buckets", 1000))
        return cls(
            emsize=int(config.get("emsize", 192)),
            nhead=int(config.get("nhead", 6)),
            nhid_factor=int(config.get("nhid_factor", 4)),
            nlayers=int(config.get("nlayers", 12)),
            features_per_group=(
                int(features_per_group)
                if features_per_group is not None
                else int(config.get("features_per_group", 1))
            ),
            n_out=n_out,
            max_num_classes=max_num_classes,
            feature_positional_embedding=config.get(
                "feature_positional_embedding", "subspace"
            )
            or "none",
            remove_empty_features=bool(config.get("remove_empty_features", True)),
            remove_duplicate_features=bool(
                config.get("remove_duplicate_features", False)
            ),
            nan_handling_enabled=bool(config.get("nan_handling_enabled", True)),
            nan_handling_y_encoder=bool(config.get("nan_handling_y_encoder", True)),
            normalize_on_train_only=bool(config.get("normalize_on_train_only", True)),
            normalize_x=bool(config.get("normalize_x", True)),
            remove_outliers=bool(config.get("remove_outliers", False)),
            normalize_by_used_features=bool(
                config.get("normalize_by_used_features", True)
            ),
            encoder_use_bias=bool(config.get("encoder_use_bias", False)),
            multiquery_item_attention_for_test_set=bool(
                config.get("multiquery_item_attention_for_test_set", True)
            ),
            seq_len=int(config.get("seq_len", 2000)),
            max_num_features=int(config.get("max_num_features", 85)),
            num_buckets=int(config.get("num_buckets", 1000)),
            mixer=mixer if mixer is not None else MixerConfig(),
            model_seed=model_seed,
        )
