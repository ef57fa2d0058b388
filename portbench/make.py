"""What a run is given, made from its ``--seed``: the weights of a
configuration (on the card, from one generator, in two calls) and the
PAD-UFES-20-shaped data.

The weights follow the published initialisation (too-z/MultiModalPFN
`model/layer.py`, `multi_head_attention.py`, `transformer.py`): uniform
attention inputs and linears by fan-in, Xavier for CAP's input projection,
LayerNorm gains 1 and the biases the published init zeroes at 0, except the
three output projections of every layer (``attn_feat/w_out``,
``attn_item/w_out``, ``mlp/w2``), which the published init zeroes and which
are drawn here from N(0, 1/fan-in): zero projections would hide every
layer's output from the check of the answers. All float32, the type the
program keeps its master weights in.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: tuple
    kind: str  # "uniform" (times `scale`), "normal" (times `scale`), "ones", "zeros"
    scale: float = 0.0


def leaves(arch: dict) -> dict[str, Leaf]:
    """Every weight of a configuration by its flat name, as the program's
    ``.npz`` names it (``params/<name>``)."""
    e, h, L = arch["emsize"], arch["nhead"], arch["nlayers"]
    d, nhid, fpg, n_out = e // h, e * arch["nhid_factor"], arch["features_per_group"], arch["n_out"]
    mix = arch["mixer"]
    H, ch, din = mix["mgm_heads"], mix["cap_heads"], mix["in_dim"]
    attn_in = math.sqrt(3.0) * math.sqrt(2.0 / (h * d + e))

    def lin(fan_in):
        return 1.0 / math.sqrt(fan_in)

    out = {
        "encoder/w": Leaf((2 * fpg, e), "uniform", lin(2 * fpg)),
        "y_encoder/w": Leaf((2, e), "uniform", lin(2)),
        "y_encoder/b": Leaf((e,), "uniform", lin(2)),
        "layers/attn_feat/w_qkv": Leaf((L, 3, h, d, e), "uniform", attn_in),
        "layers/attn_feat/w_out": Leaf((L, h, d, e), "normal", lin(d)),
        "layers/attn_item/w_qkv": Leaf((L, 3, h, d, e), "uniform", attn_in),
        "layers/attn_item/w_out": Leaf((L, h, d, e), "normal", lin(d)),
        "layers/mlp/w1": Leaf((L, e, nhid), "uniform", lin(e)),
        "layers/mlp/w2": Leaf((L, nhid, e), "normal", lin(nhid)),
        "decoder/w1": Leaf((e, nhid), "uniform", lin(e)),
        "decoder/b1": Leaf((nhid,), "uniform", lin(e)),
        "decoder/w2": Leaf((nhid, n_out), "uniform", lin(nhid)),
        "decoder/b2": Leaf((n_out,), "uniform", lin(nhid)),
        "feat_pos_emb/w": Leaf((e // 4, e), "uniform", lin(e // 4)),
        "feat_pos_emb/b": Leaf((e,), "uniform", lin(e // 4)),
        "mixer/mgm/ln_g": Leaf((H, din), "ones"),
        "mixer/mgm/ln_b": Leaf((H, din), "zeros"),
        "mixer/mgm/w1": Leaf((H, din, din), "uniform", lin(din)),
        "mixer/mgm/b1": Leaf((H, din), "uniform", lin(din)),
        "mixer/mgm/w2": Leaf((H, din // 2, e), "uniform", lin(din // 2)),
        "mixer/mgm/b2": Leaf((H, e), "uniform", lin(din // 2)),
        "mixer/cap/queries": Leaf((ch, e), "normal", 1e-2),
        "mixer/cap/q_proj_w": Leaf((e, e), "uniform", lin(e)),
        "mixer/cap/in_proj_w": Leaf((3 * e, e), "uniform", math.sqrt(6.0 / (e + 3 * e))),
        "mixer/cap/in_proj_b": Leaf((3 * e,), "zeros"),
        "mixer/cap/out_proj_w": Leaf((e, e), "uniform", lin(e)),
        "mixer/cap/out_proj_b": Leaf((e,), "zeros"),
        "mixer/cap/ffn_w1": Leaf((e, 2 * e), "uniform", lin(e)),
        "mixer/cap/ffn_b1": Leaf((2 * e,), "uniform", lin(e)),
        "mixer/cap/ffn_w2": Leaf((2 * e, e), "uniform", lin(2 * e)),
        "mixer/cap/ffn_b2": Leaf((e,), "uniform", lin(2 * e)),
    }
    for n in ("k_norm", "q_norm", "out_norm"):
        out[f"mixer/cap/{n}_g"] = Leaf((e,), "ones")
        out[f"mixer/cap/{n}_b"] = Leaf((e,), "zeros")
    return out


def make_weights(arch: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The flat weights, float32 on ``device``: every uniform leaf from one
    ``torch.rand`` and every normal leaf from one ``torch.randn`` of a
    generator seeded with ``seed``."""
    spec = leaves(arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pools = {}
    for kind, draw in (("uniform", torch.rand), ("normal", torch.randn)):
        n = sum(math.prod(lf.shape) for lf in spec.values() if lf.kind == kind)
        pools[kind] = draw(n, generator=gen, device=device, dtype=torch.float32)
    pools["uniform"] = pools["uniform"] * 2.0 - 1.0
    offsets = dict.fromkeys(pools, 0)
    out = {}
    for name in sorted(spec):
        lf = spec[name]
        if lf.kind in pools:
            n = math.prod(lf.shape)
            o = offsets[lf.kind]
            out[name] = pools[lf.kind][o:o + n].view(lf.shape) * lf.scale
            offsets[lf.kind] = o + n
        else:
            fill = torch.ones if lf.kind == "ones" else torch.zeros
            out[name] = fill(lf.shape, device=device, dtype=torch.float32)
    return out


def model_seed(seed: int) -> int:
    """The seed of the feature positional embedding's draws (nonzero)."""
    return 1 + int(seed) % (2**31 - 1)


def npz_config(arch: dict, seed: int) -> dict:
    """The model configuration the program's ``.npz`` carries."""
    keys = ("emsize", "nhead", "nhid_factor", "nlayers", "features_per_group", "n_out",
            "max_num_classes", "num_buckets", "seq_len", "max_num_features",
            "multiquery_item_attention_for_test_set")
    return {**{k: arch[k] for k in keys}, "mixer": dict(arch["mixer"]), "model_seed": model_seed(seed)}


def write_npz(path: Path, weights: dict[str, torch.Tensor], arch: dict, seed: int) -> None:
    """The weights in the program's model file format: ``params/<name>``
    arrays and the configuration as JSON."""
    arrays = {f"params/{k}": v.cpu().numpy() for k, v in weights.items()}
    np.savez(path, config=np.asarray(json.dumps(npz_config(arch, seed))), **arrays)


def pad_ufes_like(seed: int, data: dict):
    """PAD-UFES-20-shaped rows (too-z/MultiModalPFN `datasets/pad_ufes_20.py`:
    21 clinical features, 14 of them boolean, 4 ordinal categories, 3
    numeric; 2% missing; 6 diagnoses) with one 768-wide image embedding a
    row that carries the class, as a DINOv2 CLS token would. Returns X
    (n, 21) float64 with NaN, the embeddings (n, 1, 768) float32, the class
    codes (n,) int64."""
    rng = np.random.default_rng(seed)
    n, k, f = data["rows"], data["classes"], data["features"]
    y = rng.integers(0, k, size=n)
    centers = rng.normal(size=(k, f))
    X = centers[y] + rng.normal(size=(n, f))
    X[:, :14] = (X[:, :14] > 0).astype(np.float64)
    for j in range(14, 18):
        X[:, j] = np.round(np.clip(X[:, j], -3, 3)) + 3
    X[rng.random(size=X.shape) < 0.02] = np.nan
    dirs = rng.normal(size=(k, data["image_dim"]))
    emb = dirs[y][:, None, :] + 0.7 * rng.normal(size=(n, data["image_tokens"], data["image_dim"]))
    return X, emb.astype(np.float32), y


def held_out_split(n: int, test_share: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The served cells' train and held-out rows, drawn from the seed."""
    perm = np.random.default_rng([seed, 2]).permutation(n)
    n_test = int(round(n * test_share))
    return np.sort(perm[n_test:]), np.sort(perm[:n_test])
