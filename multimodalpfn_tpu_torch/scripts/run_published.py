"""One-command day-one runner: published checkpoint + a real dataset directory
→ north-star configs 1-4 end-to-end (download → embed → fine-tune →
fit/predict → AUROC), on the card. The port of the JAX package's
`scripts/run_published.py`, with ``--device``.

Usage:
    python -m multimodalpfn_tpu_torch.scripts.run_published --data-root data [--ckpt auto]
        [--configs 1,2,3,4] [--seeds 5] [--steps 100]
        [--mgm-heads 16] [--cap-heads 8] [--device cuda]

Expects ``<data-root>/pad_ufes_20/metadata.csv`` (+ ``imgs/`` for embedding
generation; precomputed embedding caches under ``embeddings/`` are honored
first, matching the reference cache contract `datasets/pad_ufes_20.py:66-107`).
The checkpoint resolves through the downloader chain (HF hub → direct URLs,
`models/download.py`; reference `loading.py:101-251`); pass ``--ckpt`` to use a
local file or ``random:<seed>`` for a smoke run without artifacts.

Configs:
  1. TabPFN-v2 tabular-only on the clinical features — no fine-tune, direct
     fit/predict with the published weights (AUROC parity config).
  2. MMPFN tabular+image: 100-step fine-tune, preprocessing-off refit
     (reference `run.py:26-129` protocol).
  3. MMPFN tabular+text: clinical-note sentences templated from the tabular
     row, embedded with ELECTRA CLS (`modal/text.py`).
  4. Tri-modal tabular+image+text (token concat), ensemble of 8 members.
"""

from __future__ import annotations

import argparse
import json
import logging
import tempfile
import time
from pathlib import Path

import numpy as np

from multimodalpfn_tpu_torch.scripts import cli_device

logger = logging.getLogger("run_published")


def clinical_notes(df) -> list[str]:
    """Template each PAD-UFES row into a clinical-note sentence (the text
    modality of north-star config 3; PAD-UFES ships no free text, so the
    notes verbalize the clinical features)."""
    notes = []
    for _, r in df.iterrows():
        symptoms = [
            c for c in ("itch", "grew", "hurt", "bleed", "elevation", "changed")
            if str(r.get(c, "")).upper() in ("TRUE", "1", "YES")
        ]
        notes.append(
            f"Patient aged {r.get('age', 'unknown')}, {r.get('gender', 'unknown')}, "
            f"from region {r.get('region', 'unknown')}. "
            f"Lesion diameters {r.get('diameter_1', '?')} by {r.get('diameter_2', '?')} mm. "
            f"Symptoms: {', '.join(symptoms) if symptoms else 'none reported'}. "
            f"Smoker: {r.get('smoke', 'unknown')}; drinks: {r.get('drink', 'unknown')}; "
            f"family skin cancer history: {r.get('skin_cancer_history', 'unknown')}."
        )
    return notes


def text_embeddings(ds, cache_root: Path, device: str = "cuda") -> np.ndarray:
    """ELECTRA CLS embeddings of the templated clinical notes, cached under the
    standard embeddings root (cache-first, like every modality here)."""
    cache = cache_root / ds.name / f"{ds.name}_clinical_electra.npz"
    if cache.exists():
        return np.load(cache)["emb"]
    from multimodalpfn_tpu_torch.modal.text import embed_texts

    emb = embed_texts(clinical_notes(ds.df), device=device)
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(cache, emb=emb)
    return emb


def eval_config(
    *,
    name: str,
    X: np.ndarray,
    emb: np.ndarray | None,
    y: np.ndarray,
    n_categorical: int,
    ckpt: str | Path,
    mgm_heads: int,
    cap_heads: int,
    n_estimators: int,
    seeds: int,
    steps: int,
    finetune: bool,
    device: str = "cuda",
) -> dict:
    """The reference `run.py:26-129` per-seed protocol: 80/20 split, nanmin-1
    impute, (optional) frozen-input fine-tune, preprocessing-off refit,
    fit/predict. Reports accuracy AND AUROC (ovo-macro)."""
    from multimodalpfn_tpu_torch import MMPFNClassifier, TabPFNClassifier
    from multimodalpfn_tpu_torch.estimator.interface_config import ModelInterfaceConfig
    from multimodalpfn_tpu_torch.hpo.experiment import nanmin_impute
    from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn
    from multimodalpfn_tpu_torch.train.metrics import get_scorer

    auroc = get_scorer("roc_auc")
    accs, aucs = [], []
    t0 = time.time()
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(y))
        ntr = int(len(y) * 0.8)
        tr, te = perm[:ntr], perm[ntr:]
        X_train, X_test = nanmin_impute(X[tr]), nanmin_impute(X[te])
        emb_train = emb[tr] if emb is not None else None
        emb_test = emb[te] if emb is not None else None

        # the fine-tuned checkpoint lives in a temporary directory until the
        # refit is done; `fine_tune_mmpfn` closes its snapshot writer before
        # it returns, so no background write can race the directory's
        # removal (the JAX script waits for its pending snapshots here)
        with tempfile.TemporaryDirectory() as td:
            model_path: str | Path = ckpt
            if finetune:
                model_path = Path(td) / f"ft_{name}_{seed}.ckpt"
                fine_tune_mmpfn(
                    mixer_type="MGM+CAP",
                    mgm_heads=mgm_heads,
                    cap_heads=cap_heads,
                    features_per_group=1,
                    path_to_base_model=str(ckpt),
                    save_path_to_fine_tuned_model=model_path,
                    finetuning_config={
                        "learning_rate": 1e-5,
                        "max_steps": steps,
                    },
                    validation_metric="log_loss",
                    task_type="multiclass",
                    X_train=X_train,
                    image_train=emb_train,
                    y_train=y[tr],
                    random_seed=seed,
                    freeze_input=True,
                    logger_level=30,
                    device=device,
                )

            no_preproc = ModelInterfaceConfig(
                FINGERPRINT_FEATURE=False,
                PREPROCESS_TRANSFORMS=[PreprocessorConfig(name="none")],
            )
            common = dict(
                model_path=model_path,
                ignore_pretraining_limits=True,
                n_estimators=n_estimators,
                categorical_features_indices=list(range(n_categorical)),
                random_state=seed,
                device=device,
            )
            if emb is None:
                clf = TabPFNClassifier(**common)
                clf.fit(X_train, y[tr])
                proba = clf.predict_proba(X_test)
            else:
                clf = MMPFNClassifier(
                    inference_config=no_preproc,
                    mixer_type="MGM+CAP",
                    mgm_heads=mgm_heads,
                    cap_heads=cap_heads,
                    features_per_group=1,
                    **common,
                )
                clf.fit(X_train, emb_train, y[tr])
                proba = clf.predict_proba(X_test, emb_test)
        pred = clf.classes_[np.argmax(proba, axis=1)]
        accs.append(float(np.mean(pred == y[te])))
        aucs.append(float(auroc(y[te], proba)))
        logger.info(
            "[%s] seed %d: acc %.4f auroc %.4f", name, seed, accs[-1], aucs[-1]
        )
    return {
        "config": name,
        "accuracy_mean": float(np.mean(accs)),
        "accuracy_std": float(np.std(accs)),
        "auroc_mean": float(np.mean(aucs)),
        "auroc_std": float(np.std(aucs)),
        "n_seeds": seeds,
        "wall_s": round(time.time() - t0, 1),
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--embeddings-root", default="embeddings")
    ap.add_argument(
        "--ckpt", default="auto",
        help="'auto' = download the published tabpfn-v2-classifier.ckpt; "
        "a path; or 'random:<seed>' for an artifact-free smoke run",
    )
    ap.add_argument("--configs", default="1,2,3,4")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mgm-heads", type=int, default=16)
    ap.add_argument("--cap-heads", type=int, default=8)
    ap.add_argument("--results", default="results/published_run.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = str(cli_device(args.device))
    logging.basicConfig(level=logging.INFO)

    from multimodalpfn_tpu_torch.datasets.loaders import PADUFES20Dataset
    from multimodalpfn_tpu_torch.models.download import ensure_model

    ckpt: str | Path = args.ckpt
    if ckpt == "auto":
        ckpt = ensure_model(None, "classifier")
        logger.info("checkpoint: %s", ckpt)

    ds = PADUFES20Dataset(
        str(Path(args.data_root) / "pad_ufes_20"),
        embeddings_root=args.embeddings_root,
        device=device,
    )
    X = np.asarray(ds.x, dtype=float)
    y = np.asarray(ds.y)
    n_cat = len(ds.cat_features)
    want = {int(c) for c in str(args.configs).split(",") if c.strip()}

    img = ds.get_embeddings() if want & {2, 4} else None
    txt = (
        text_embeddings(ds, Path(args.embeddings_root), device) if want & {3, 4} else None
    )

    runs = []
    common = dict(
        X=X, y=y, n_categorical=n_cat, ckpt=ckpt, mgm_heads=args.mgm_heads,
        cap_heads=args.cap_heads, seeds=args.seeds, steps=args.steps, device=device,
    )
    if 1 in want:
        runs.append(eval_config(
            name="1-tabular-only", emb=None, n_estimators=4, finetune=False,
            **common,
        ))
    if 2 in want:
        runs.append(eval_config(
            name="2-tabular+image", emb=img, n_estimators=4, finetune=True,
            **common,
        ))
    if 3 in want:
        runs.append(eval_config(
            name="3-tabular+text", emb=txt, n_estimators=4, finetune=True,
            **common,
        ))
    if 4 in want:
        tri = np.concatenate([img, txt], axis=1)  # (B, 2, 768) token concat
        runs.append(eval_config(
            name="4-trimodal-8member", emb=tri, n_estimators=8, finetune=True,
            **common,
        ))

    out = {"checkpoint": str(ckpt), "dataset": "pad_ufes_20", "runs": runs}
    results = Path(args.results)
    results.parent.mkdir(parents=True, exist_ok=True)
    results.write_text(json.dumps(out, indent=2))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
