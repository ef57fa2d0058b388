"""Experiments: a grid sweep over the mixer head counts, each cell
fine-tuned on several seeds and evaluated by fit + predict accuracy.

Protocol of reference `mmpfn/run.py:26-201`, as the JAX package's
`multimodalpfn_tpu/hpo/experiment.py` runs it: for each (mgm_heads,
cap_heads) cell (pruned where mgm < cap), seeds of {random 80/20 split,
NaN -> column nanmin - 1, a 100-step fine-tune at lr 1e-5 with frozen input
encoders, the fine-tuned checkpoint reloaded with preprocessing off
(``FINGERPRINT_FEATURE=False``, ``PREPROCESS_TRANSFORMS=[none]``), fit +
predict accuracy}; the study maximises the mean accuracy.
`run_experiment_cross_cell` fine-tunes every cell of a ``cap_heads`` group in
one sweep (`train/finetune_batch.py`). Everything runs on ``device`` (the
card unless the caller asks for the CPU).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

import numpy as np
import torch

from multimodalpfn_tpu_torch.hpo.study import GridStudy, Trial, TrialPruned

logger = logging.getLogger(__name__)


def nanmin_impute(X: np.ndarray) -> np.ndarray:
    """NaN -> column nanmin - 1 (reference `run.py:61-66`), float64."""
    X = np.array(X, dtype=np.float64, copy=True)
    for i in range(X.shape[1]):
        col = X[:, i]
        if np.isnan(col).any():
            col[np.isnan(col)] = np.nanmin(col) - 1 if np.isfinite(np.nanmin(col)) else -1
    return X


def _no_preprocessing():
    from multimodalpfn_tpu_torch.estimator.interface_config import ModelInterfaceConfig
    from multimodalpfn_tpu_torch.preprocess.ensemble import PreprocessorConfig

    return ModelInterfaceConfig(FINGERPRINT_FEATURE=False,
                                PREPROCESS_TRANSFORMS=[PreprocessorConfig(name="none")])


def _accuracy(path, *, mixer_type, mgm_heads, cap_heads, features_per_group, n_categorical, device,
              X_train, image_train, y_train, X_test, image_test, y_test) -> float:
    """The fine-tuned checkpoint at ``path`` reloaded with preprocessing off,
    fitted on the train rows; its accuracy on the test rows (scikit-learn's
    ``accuracy_score`` of the predicted labels)."""
    from multimodalpfn_tpu_torch import MMPFNClassifier

    clf = MMPFNClassifier(
        model_path=path, inference_config=_no_preprocessing(), ignore_pretraining_limits=True,
        mixer_type=mixer_type, mgm_heads=mgm_heads, cap_heads=cap_heads,
        features_per_group=features_per_group,
        categorical_features_indices=list(range(n_categorical)), device=device,
    )
    clf.fit(X_train, image_train, y_train)
    return float(np.average(np.asarray(y_test) == clf.predict(X_test, image_test)))


def evaluate_cell(
    *,
    X: np.ndarray,
    embeddings: np.ndarray,
    y: np.ndarray,
    n_categorical: int,
    mgm_heads: int,
    cap_heads: int,
    mixer_type: str = "MGM+CAP",
    features_per_group: int = 2,
    n_seeds: int = 5,
    path_to_base_model: str = "auto",
    checkpoint_dir: str = "./checkpoints",
    dataset_name: str = "dataset",
    finetuning_config: dict | None = None,
    time_limit: int = 60,
    vmapped_seeds: bool = False,
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """One grid cell: n_seeds × (split, impute, fine-tune, evaluate). With
    ``vmapped_seeds`` all seeds fine-tune in one sweep
    (`train/finetune_batch.fine_tune_batched`) instead of one after another.
    A seed whose fine-tune raises is left out (reference `run.py:72-98`)."""
    if vmapped_seeds:
        return _evaluate_cell_vmapped(
            X=X, embeddings=embeddings, y=y, n_categorical=n_categorical, mgm_heads=mgm_heads,
            cap_heads=cap_heads, mixer_type=mixer_type, features_per_group=features_per_group,
            n_seeds=n_seeds, path_to_base_model=path_to_base_model, checkpoint_dir=checkpoint_dir,
            dataset_name=dataset_name, finetuning_config=finetuning_config, time_limit=time_limit,
            device=device,
        )
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn

    accs = []
    for seed in range(n_seeds):
        perm = np.random.default_rng(seed).permutation(len(y))
        ntr = int(len(y) * 0.8)
        tr, te = perm[:ntr], perm[ntr:]
        X_train, X_test = nanmin_impute(X[tr]), nanmin_impute(X[te])
        save_path = Path(checkpoint_dir) / f"finetuned_mmpfn_{dataset_name}.ckpt"
        try:
            fine_tune_mmpfn(
                mixer_type=mixer_type, mgm_heads=mgm_heads, cap_heads=cap_heads,
                features_per_group=features_per_group, path_to_base_model=path_to_base_model,
                save_path_to_fine_tuned_model=save_path, time_limit=time_limit,
                finetuning_config={"learning_rate": 1e-5, "max_steps": 100, **(finetuning_config or {})},
                validation_metric="log_loss", task_type="multiclass", X_train=X_train,
                image_train=embeddings[tr], y_train=y[tr], random_seed=seed, freeze_input=True,
                device=device,
            )
        except Exception as e:  # reference run.py:72-98 continues on failure
            logger.warning("fine-tuning failed (seed %d): %r", seed, e)
            continue
        acc = _accuracy(save_path, mixer_type=mixer_type, mgm_heads=mgm_heads, cap_heads=cap_heads,
                        features_per_group=features_per_group, n_categorical=n_categorical,
                        device=device, X_train=X_train, image_train=embeddings[tr], y_train=y[tr],
                        X_test=X_test, image_test=embeddings[te], y_test=y[te])
        logger.info("seed %d accuracy %.4f", seed, acc)
        accs.append(acc)
    return {
        "mean_accuracy": float(np.mean(accs)) if accs else 0.0,
        "std_accuracy": float(np.std(accs)) if accs else 0.0,
        "n_completed_seeds": len(accs),
    }


def _outer_split(s: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    perm = np.random.default_rng(s).permutation(n)
    ntr = int(n * 0.8)
    return perm[:ntr], perm[ntr:]


def _inner_split(s: int, tr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """An 80/20 split of the outer train rows (the outer test rows never
    reach the fine-tune)."""
    inner = np.random.default_rng(10_000 + s).permutation(len(tr))
    n_val = int(round(len(tr) * 0.2))
    return tr[inner[n_val:]], tr[inner[:n_val]]


def _evaluate_cell_vmapped(
    *, X, embeddings, y, n_categorical, mgm_heads, cap_heads, mixer_type, features_per_group,
    n_seeds, path_to_base_model, checkpoint_dir, dataset_name, finetuning_config, time_limit, device,
) -> dict[str, Any]:
    """All seeds of a grid cell fine-tuned in one sweep, then evaluated one
    by one."""
    from multimodalpfn_tpu_torch.models.loading import save_model
    from multimodalpfn_tpu_torch.train.finetune_batch import extract_run_params, fine_tune_batched

    seeds = list(range(n_seeds))
    outer = {s: _outer_split(s, len(y)) for s in seeds}
    Xi = nanmin_impute(X)
    out = fine_tune_batched(
        run_splits=[_inner_split(s, outer[s][0]) for s in seeds],
        mixer_type=mixer_type, mgm_heads=mgm_heads, cap_heads=cap_heads,
        features_per_group=features_per_group, path_to_base_model=path_to_base_model,
        X=Xi, image=embeddings, y=y, seeds=seeds,
        finetuning_config={"learning_rate": 1e-5, "max_steps": 100, **(finetuning_config or {})},
        time_limit=time_limit, device=device,
    )
    ckpt_dir = Path(checkpoint_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    accs = []
    for r, s in enumerate(seeds):
        params_r, cfg_r = extract_run_params(out, r)
        path = ckpt_dir / f"finetuned_mmpfn_{dataset_name}_seed{s}.ckpt"
        save_model(path, params_r, cfg_r, criterion_borders=out.get("criterion_borders"))
        tr, te = outer[s]
        accs.append(_accuracy(path, mixer_type=mixer_type, mgm_heads=mgm_heads, cap_heads=cap_heads,
                              features_per_group=features_per_group, n_categorical=n_categorical,
                              device=device, X_train=Xi[tr], image_train=embeddings[tr], y_train=y[tr],
                              X_test=Xi[te], image_test=embeddings[te], y_test=y[te]))
    return {
        "mean_accuracy": float(np.mean(accs)) if accs else 0.0,
        "std_accuracy": float(np.std(accs)) if accs else 0.0,
        "n_completed_seeds": len(accs),
    }


def _grid_study(config: dict[str, Any]) -> GridStudy:
    return GridStudy(
        search_space={"mgm_heads": list(config["mgm_heads_list"]),
                      "cap_heads": list(config["cap_heads_list"])},
        direction="maximize",
    )


def run_experiment_cross_cell(
    *,
    X: np.ndarray,
    embeddings: np.ndarray,
    y: np.ndarray,
    n_categorical: int,
    config: dict[str, Any],
    dataset_name: str = "dataset",
    path_to_base_model: str = "auto",
    n_seeds: int = 5,
    results_path: str | None = None,
    checkpoint_dir: str = "./checkpoints",
    finetuning_config: dict | None = None,
    time_limit: int = 3600,
    max_runs_per_group: int = 64,
    mesh=None,
    device: str | torch.device = "cuda",
) -> GridStudy:
    """Cross-cell grid sweep: cells sharing ``cap_heads`` fine-tune their
    seeds × cells as one sweep over padded mixers
    (`train/finetune_batch.fine_tune_batched_cells`), chunked to at most
    ``max_runs_per_group`` runs of whole cells. Each run's checkpoint is
    saved at its cell's true shape and evaluated; every grid cell becomes a
    trial (``"pruned"`` where mgm < cap). ``mesh`` must be None."""
    from multimodalpfn_tpu_torch.models.loading import save_model
    from multimodalpfn_tpu_torch.train.finetune_batch import extract_run_params, fine_tune_batched_cells

    mixer_type = config.get("mixer_type", "MGM+CAP")
    fpg = config.get("features_per_group", 2)
    grid = [(int(m), int(c)) for m in config["mgm_heads_list"] for c in config["cap_heads_list"]]
    seeds = list(range(n_seeds))
    Xi = nanmin_impute(X)

    groups: dict[int, list[dict]] = {}
    for m, c in grid:
        if m < c:  # reference run.py:34-35
            continue
        groups.setdefault(c, []).append({
            "mgm_heads": m, "cap_heads": c, "seeds": seeds,
            "run_splits": [_inner_split(s, _outer_split(s, len(y))[0]) for s in seeds],
        })

    cell_accs: dict[tuple[int, int], list[float]] = {}
    ckpt_dir = Path(checkpoint_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    for cap, cells in groups.items():
        cells_per_chunk = max(1, max_runs_per_group // len(seeds))
        for i in range(0, len(cells), cells_per_chunk):
            chunk = cells[i : i + cells_per_chunk]
            logger.info("cross-cell group cap=%d: %d cells x %d seeds in one sweep", cap, len(chunk), len(seeds))
            out = fine_tune_batched_cells(
                cells=chunk, mixer_type=mixer_type, features_per_group=fpg,
                path_to_base_model=path_to_base_model, X=Xi, image=embeddings, y=y,
                finetuning_config={"learning_rate": 1e-5, "max_steps": 100, **(finetuning_config or {})},
                time_limit=time_limit, static_seed=seeds[0], mesh=mesh, device=device,
            )
            for r, (ci, s) in enumerate(out["run_cells"]):
                m = chunk[ci]["mgm_heads"]
                params_r, cfg_r = extract_run_params(out, r)
                path = ckpt_dir / f"finetuned_mmpfn_{dataset_name}_m{m}c{cap}_seed{s}.ckpt"
                save_model(path, params_r, cfg_r, criterion_borders=out.get("criterion_borders"))
                tr, te = _outer_split(s, len(y))
                cell_accs.setdefault((m, cap), []).append(_accuracy(
                    path, mixer_type=mixer_type, mgm_heads=m, cap_heads=cap, features_per_group=fpg,
                    n_categorical=n_categorical, device=device, X_train=Xi[tr], image_train=embeddings[tr],
                    y_train=y[tr], X_test=Xi[te], image_test=embeddings[te], y_test=y[te]))

    study = _grid_study(config)
    for m, c in grid:
        trial = Trial(number=len(study.trials), params={"mgm_heads": m, "cap_heads": c})
        study.trials.append(trial)
        if m < c:
            trial.state = "pruned"
            continue
        accs = cell_accs.get((m, c), [])
        trial.value = float(np.mean(accs)) if accs else 0.0
        trial.state = "complete"
        trial.set_user_attr("std_accuracy", float(np.std(accs)) if accs else 0.0)
        trial.set_user_attr("n_completed_seeds", len(accs))
    if results_path:
        study.save(results_path)
    return study


def run_experiment(
    *,
    X: np.ndarray,
    embeddings: np.ndarray,
    y: np.ndarray,
    n_categorical: int,
    config: dict[str, Any],
    dataset_name: str = "dataset",
    path_to_base_model: str = "auto",
    n_seeds: int = 5,
    results_path: str | None = None,
    device: str | torch.device = "cuda",
    **cell_kwargs,
) -> GridStudy:
    """Full grid sweep for one dataset, one cell after another
    (`evaluate_cell`). ``config`` uses the reference YAML schema
    (`configs/pad_ufes_20.yaml`): mgm_heads_list, cap_heads_list,
    features_per_group, mixer_type. A cell that raises is recorded as a
    ``"failed"`` trial with its error."""
    study = _grid_study(config)

    def objective(trial: Trial) -> float:
        mgm = trial.suggest_categorical("mgm_heads", config["mgm_heads_list"])
        cap = trial.suggest_categorical("cap_heads", config["cap_heads_list"])
        if mgm < cap:  # reference run.py:34-35
            raise TrialPruned
        result = evaluate_cell(
            X=X, embeddings=embeddings, y=y, n_categorical=n_categorical, mgm_heads=mgm,
            cap_heads=cap, mixer_type=config.get("mixer_type", "MGM+CAP"),
            features_per_group=config.get("features_per_group", 2), n_seeds=n_seeds,
            path_to_base_model=path_to_base_model, dataset_name=dataset_name, device=device,
            **cell_kwargs,
        )
        trial.set_user_attr("std_accuracy", result["std_accuracy"])
        trial.set_user_attr("n_completed_seeds", result["n_completed_seeds"])
        return result["mean_accuracy"]

    study.optimize(objective, catch=(Exception,))
    if results_path:
        study.save(results_path)
    return study


def load_experiment_config(path: str | Path) -> dict[str, Any] | None:
    """The experiment's YAML config (the flat schema of ``configs/*.yaml``),
    as ``yaml.safe_load`` returns it, read without PyYAML
    (`utils/flat_yaml.py`); a file outside that schema raises ValueError."""
    from multimodalpfn_tpu_torch.utils import flat_yaml

    return flat_yaml.load(path)
