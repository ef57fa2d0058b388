"""The plain reference of MMPFN's PetFinder image+text configuration: the
forward of `model.py` with two features a group and item attention formed
in blocks of query rows, and the ensemble served with preprocessing off
(``PreprocessorConfig("none")``, no fingerprint feature), as
too-z/MultiModalPFN's ``run.py`` evaluates a fine-tuned model and as
``hpo/experiment._accuracy`` calls the classifier. Float32 (TF32 off) or
the float8 control of `model.Arith`.

The feature encoder follows TabPFN-v2's steps (too-z/MultiModalPFN
`model/encoders.py`: RemoveEmptyFeatures, NanHandling, remove_outliers,
normalize_data, VariableNumFeatures) on groups of ``features_per_group``
columns, with the last group zero-padded (`transformer.py:626-657`).
Departures from the original, each the port's too: a constant column is
zeroed and the kept columns of its group move left, stably, in place of the
original's ``select_features`` over a flattened batch (the same values for
one member at a time); the NaN indicators are formed after that move, so
they follow their column.

The float8 control rounds each product's operands with a scale per
operand; where a product is formed in blocks (the item attention's query
rows, the token columns), the scale is the block's.

Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import model
from portbench.reference.model import Arith, group, ln
from portbench.reference.prep.ensemble import EnsembleConfig, PreprocessorConfig, fit_preprocessing
from portbench.reference.prep.rng import infer_random_state

QUERY_BLOCK = 1024  # query rows whose item-attention scores are formed at once
MAX_UNIQUE_FOR_CATEGORY = 30  # TabPFN-v2's `ModelInterfaceConfig` defaults
MIN_UNIQUE_FOR_NUMERICAL = 4
MIN_SAMPLES_FOR_INFERENCE = 100
OUTLIER_SIGMA = 12.0  # the classifier's "auto" outlier removal


# --- the estimator's encoding of X (TabPFN-v2 `utils.py`: _fix_dtypes,
# _get_ordinal_encoder, infer_categorical_features) -----------------------------

class OrdinalCodes:
    """The categorical columns as the positions of their values among the
    sorted train values (unseen values -1), moved before the other columns."""

    def __init__(self, X_train: np.ndarray, categorical: list[int]):
        self.cat = list(categorical)
        self.rest = [j for j in range(X_train.shape[1]) if j not in self.cat]
        self.values = [np.unique(X_train[:, j]) for j in self.cat]

    def __call__(self, X: np.ndarray) -> np.ndarray:
        cols = []
        for j, vals in zip(self.cat, self.values):
            pos = np.clip(np.searchsorted(vals, X[:, j]), 0, len(vals) - 1)
            cols.append(np.where(vals[pos] == X[:, j], pos, -1).astype(np.float64))
        return np.column_stack(cols + [X[:, self.rest].astype(np.float64)])


def categorical_indices(X: np.ndarray, provided: list[int]) -> list[int]:
    """A given column stays categorical with at most 30 distinct values; any
    other is categorical with fewer than 4, on more than 100 rows."""
    out = []
    for j in range(X.shape[1]):
        n = len(np.unique(X[:, j]))
        if j in provided:
            if n <= MAX_UNIQUE_FOR_CATEGORY:
                out.append(j)
        elif X.shape[0] > MIN_SAMPLES_FOR_INFERENCE and n < MIN_UNIQUE_FOR_NUMERICAL:
            out.append(j)
    return out


# --- the forward ------------------------------------------------------------------

def _varies(x: torch.Tensor) -> torch.Tensor:
    """Which columns of ``x`` (S, G, n) take more than one value over all
    rows (NaN differs from everything)."""
    return (x[1:] == x[:1]).sum(0) != x.shape[0] - 1


def encode_x(w: torch.Tensor, x: torch.Tensor, sep: int, fpg: int, outlier_sigma: float | None,
             ar: Arith) -> torch.Tensor:
    """``x`` (S, F) float32 -> (S, G, e), G = ceil(F / fpg) groups of
    ``fpg`` columns, the last zero-padded."""
    S, n_feat = x.shape
    x = torch.cat([x, x.new_zeros((S, (-n_feat) % fpg))], dim=1).reshape(S, -1, fpg)
    varies = _varies(x)  # (G, fpg)
    order = torch.argsort((~varies).to(torch.int8), dim=-1, stable=True)  # kept columns first
    x = torch.gather(x, -1, order[None].expand_as(x))
    x = torch.where(torch.gather(varies, -1, order), x, 0.0)
    x, ind = model._nan_handling(x, sep)
    if outlier_sigma is not None:
        data = x[:sep]
        m1, s1 = model._nanmean(data), model._nanstd(data)
        clean = torch.where((data > m1 + s1 * outlier_sigma) | (data < m1 - s1 * outlier_sigma),
                            float("nan"), data)
        m2, s2 = model._nanmean(clean), model._nanstd(clean)
        lo, hi = m2 - s2 * outlier_sigma, m2 + s2 * outlier_sigma
        x = torch.maximum(-torch.log1p(x.abs()) + lo, x)
        x = torch.minimum(torch.log1p(x.abs()) + hi, x)
    mean, std = model._nanmean(x[:sep]), model._nanstd(x[:sep]) + 1e-20
    if S == 1 or sep == 1:
        std = torch.ones_like(std)
    x = ((x - mean) / std).clamp(-100, 100)
    used = _varies(x).sum(-1, keepdim=True).to(x.dtype).clamp(min=1.0)
    x = x * torch.sqrt(fpg / used)  # VariableNumFeatures within each group
    return ar.mm(torch.cat([x, ind], dim=-1), w)


def _query_blocks(sep: int, S: int, size: int):
    """(start, stop, train) row blocks: the train rows, then the test rows."""
    for lo, hi, train in ((0, sep, True), (sep, S, False)):
        for a in range(lo, hi, size):
            yield a, min(a + size, hi), train


def item_attention(x, w_qkv, w_out, sep: int, ar: Arith, query_block: int = QUERY_BLOCK):
    """`model._item_attention` with the scores of ``query_block`` query rows
    at a time: train rows attend to train rows with every head, test rows to
    train rows with KV head 0 shared by all query heads."""
    d = w_qkv.shape[2]
    outs = []
    for c in range(0, x.shape[1], model.TOKEN_BLOCK):
        xc = x[:, c:c + model.TOKEN_BLOCK].transpose(0, 1)  # (tb, S, e)
        k = ar.ein("tsi,hdi->tshd", xc[:, :sep], w_qkv[1])
        v = ar.ein("tsi,hdi->tshd", xc[:, :sep], w_qkv[2])
        rows = []
        for a, b, train in _query_blocks(sep, x.shape[0], query_block):
            q = ar.ein("tsi,hdi->tshd", xc[:, a:b], w_qkv[0])
            if train:
                pr = torch.softmax(ar.ein("tqhd,tkhd->thqk", q, k) / math.sqrt(d), dim=-1)
                o = ar.ein("thqk,tkhd->tqhd", pr, v)
            else:
                pr = torch.softmax(ar.ein("tqhd,tkd->thqk", q, k[:, :, 0]) / math.sqrt(d), dim=-1)
                o = ar.ein("thqk,tkd->tqhd", pr, v[:, :, 0])
            rows.append(ar.ein("tqhd,hdo->tqo", o, w_out))
        outs.append(torch.cat(rows, dim=1).transpose(0, 1))
    return torch.cat(outs, dim=1)


def encoder_layer(x, lp: dict, sep: int, ar: Arith):
    x = ln(x + model._feature_attention(x, lp["attn_feat/w_qkv"], lp["attn_feat/w_out"], ar))
    x = ln(x + item_attention(x, lp["attn_item/w_qkv"], lp["attn_item/w_out"], sep, ar))
    h = ar.mm(F.gelu(ar.mm(x, lp["mlp/w1"])), lp["mlp/w2"])
    return ln(x + h)


def forward(params: dict, arch: dict, x: torch.Tensor, y_train: torch.Tensor, image: torch.Tensor, *,
            outlier_sigma: float | None = OUTLIER_SIGMA, precision: str = "float32") -> torch.Tensor:
    """One member at inference: ``x`` (S, F) preprocessed features, the first
    ``len(y_train)`` rows the train rows; ``image`` (S, N, in) the frozen
    encoders' embeddings, one token a modality; returns the test rows'
    logits (S - sep, n_out)."""
    ar = Arith(precision)
    sep, S = y_train.shape[0], x.shape[0]
    mix = arch["mixer"]
    emb_y = model.encode_y(params["y_encoder/w"], params["y_encoder/b"], y_train, S - sep,
                           arch["max_num_classes"] >= 2, ar)
    emb_x = encode_x(params["encoder/w"], x, sep, arch["features_per_group"], outlier_sigma, ar)
    tokens = model.mgm(group(params, "mixer/mgm"), image[None], 0.0, None, ar)
    tokens = model.cap(group(params, "mixer/cap"), mix["cap_heads"], 0.0, tokens, None, ar)[0]
    emb_x = torch.cat([emb_x, tokens], dim=1)
    noise = model.subspace_noise(arch["model_seed"], emb_x.shape[1], arch["emsize"] // 4).to(x.device)
    emb_x = emb_x + ar.mm(noise, params["feat_pos_emb/w"]) + params["feat_pos_emb/b"]
    state = torch.cat([emb_x, emb_y[:, None]], dim=1)  # (S, t, e)
    layers = group(params, "layers")
    for l in range(arch["nlayers"]):
        state = encoder_layer(state, {k: v[l] for k, v in layers.items()}, sep, ar)
    hidden = F.gelu(ar.mm(state[sep:, -1], params["decoder/w1"]) + params["decoder/b1"])
    return ar.mm(hidden, params["decoder/w2"]) + params["decoder/b2"]


# --- the ensemble ------------------------------------------------------------------

class PlainMembers:
    """The classifier fitted with preprocessing off: the categorical columns
    encoded, each member's columns shuffled (no other transform, no
    fingerprint feature), its classes permuted, as the estimator draws them
    from its ``random_state``."""

    def __init__(self, X_train: np.ndarray, y_train: np.ndarray, estimator: dict, categorical: list[int]):
        _, rng = infer_random_state(estimator["random_state"])
        self.codes = OrdinalCodes(np.asarray(X_train, dtype=np.float64), categorical)
        X = self.codes(np.asarray(X_train, dtype=np.float64))
        self.classes, y = np.unique(y_train, return_inverse=True)
        self.n_classes = len(self.classes)
        configs = EnsembleConfig.generate_for_classification(
            n=estimator["n_estimators"], subsample_size=None, add_fingerprint_feature=False,
            feature_shift_decoder="shuffle", polynomial_features="no", max_index=len(X),
            preprocessor_configs=[PreprocessorConfig("none")], class_shift_method="shuffle",
            n_classes=self.n_classes, random_state=rng,
        )
        # the estimator holds the given indices against the encoded columns
        self.fitted = fit_preprocessing(configs, X, y, random_state=rng,
                                        cat_ix=categorical_indices(X, list(categorical)))
        self.temperature = estimator["softmax_temperature"]

    def widths(self) -> list[int]:
        return [Xm.shape[1] for _, _, Xm, _, _ in self.fitted]

    @torch.no_grad()
    def predict_proba(self, weights: dict, arch: dict, image_train: np.ndarray, X_test: np.ndarray,
                      image_test: np.ndarray, device, precision: str = "float32") -> np.ndarray:
        """The ensemble's probabilities of the test rows, float64."""
        img = torch.as_tensor(np.concatenate([image_train, image_test]), dtype=torch.float32,
                              device=device)
        X_test = self.codes(np.asarray(X_test, dtype=np.float64))
        probs = []
        for config, pipe, X_m, y_m, _ in self.fitted:
            x = np.concatenate([X_m, pipe.transform(X_test).X])
            logits = forward(weights, arch, torch.as_tensor(x, dtype=torch.float32, device=device),
                             torch.as_tensor(y_m, dtype=torch.float32, device=device), img,
                             precision=precision)
            out = logits.double().cpu().numpy()[:, :self.n_classes] / self.temperature
            if config.class_permutation is not None:
                out = out[..., config.class_permutation]
            out = np.exp(out - out.max(axis=1, keepdims=True))
            probs.append(out / out.sum(axis=1, keepdims=True))
        p = np.mean(probs, axis=0)
        return p / p.sum(axis=1, keepdims=True)
