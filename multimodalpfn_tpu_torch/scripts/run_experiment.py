"""Experiment CLI (replaces reference `mmpfn/run.py` + run0.sh/run1.sh): the
port of the JAX package's `scripts/run_experiment.py`, with ``--device``.

Usage:
    python -m multimodalpfn_tpu_torch.scripts.run_experiment <dataset> [task] [--data-root data]
        [--config configs/<dataset>.yaml] [--base-model auto] [--seeds 5] [--device cuda]

Datasets: pad_ufes_20 | cbis_ddsm | petfinder | cloth | airbnb | salary
(cbis_ddsm task: mass | calc; petfinder task: image | text | all).

Loads the dataset + cached embeddings (from ``embeddings/`` under the working
directory; an encoder runs on ``--device`` where a cache is missing), sweeps
the (mgm_heads, cap_heads) grid from the YAML config one cell after another
(`hpo/experiment.run_experiment`; fine-tuned checkpoints under
``./checkpoints``), and writes the study to ``<results-dir>/<dataset>[_<task>].json``.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from multimodalpfn_tpu_torch.scripts import REPO, cli_device


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset")
    ap.add_argument("task", nargs="?", default=None)
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--config", default=None)
    ap.add_argument("--base-model", default="auto")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = str(cli_device(args.device))

    logging.basicConfig(level=logging.INFO)
    from multimodalpfn_tpu_torch.datasets.loaders import (
        DATASETS,
        CBISDDSMDataset,
        PetfinderDataset,
    )
    from multimodalpfn_tpu_torch.hpo.experiment import load_experiment_config, run_experiment

    cfg_path = args.config or REPO / "configs" / f"{args.dataset}.yaml"
    config = load_experiment_config(cfg_path)

    name = args.dataset
    root = Path(args.data_root)
    if name == "cbis_ddsm":
        kind = args.task or "mass"
        ds = CBISDDSMDataset(
            str(root / "cbis_ddsm"),
            data_name=f"{kind}_case_description_train_set.csv",
            kind=kind,
            image_type=config.get("image_type", "all"),
            device=device,
        )
        ds.get_embeddings()
        tag = f"{name}_{kind}"
    elif name == "petfinder":
        ds = PetfinderDataset(str(root / "petfinder_adoption"), device=device)
        ds.get_embeddings(multimodal_type=args.task or "all")
        tag = f"{name}_{args.task or 'all'}"
    else:
        ds = DATASETS[name](str(root / name), device=device)
        ds.get_embeddings()
        tag = name

    results_dir = Path(args.results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    study = run_experiment(
        X=ds.x.astype(float),
        embeddings=ds.embeddings,
        y=ds.y,
        n_categorical=len(ds.cat_features),
        config=config,
        dataset_name=tag,
        path_to_base_model=args.base_model,
        n_seeds=args.seeds,
        results_path=str(results_dir / f"{tag}.json"),
        device=device,
    )
    out = {"best_params": study.best_params, "best_value": study.best_value}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
