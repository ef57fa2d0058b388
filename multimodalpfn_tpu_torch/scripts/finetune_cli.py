"""Fine-tuning CLI (covers both reference harnesses: `scripts_finetune_mm/` and the
tabular-only `scripts_finetune/` twin — one entry point, image optional). The
port of the JAX package's `scripts/finetune_cli.py`, with the same flags and
``--device``.

Usage:
    python -m multimodalpfn_tpu_torch.scripts.finetune_cli --x train_x.npy --y train_y.npy \
        [--image embeddings.npy] --out checkpoints/finetuned.ckpt \
        [--task multiclass|binary|regression] [--base auto] \
        [--mixer MGM+CAP --mgm-heads 16 --cap-heads 8 --fpg 2] \
        [--hps configs/finetuning_hps.yaml] [--steps 100] [--lr 1e-5] [--device cuda]

``--freeze-input`` is a ``store_true`` flag whose default is already true,
so it cannot be turned off: the JAX CLI's quirk, kept.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from multimodalpfn_tpu_torch.scripts import cli_device


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--x", default=None, help=".npy tabular features (N, F)")
    ap.add_argument("--y", required=True, help=".npy targets (N,)")
    ap.add_argument("--image", default=None, help=".npy embeddings (N, T, D)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--task", default="multiclass")
    ap.add_argument("--base", default="auto")
    ap.add_argument("--mixer", default="MGM+CAP")
    ap.add_argument("--mgm-heads", type=int, default=16)
    ap.add_argument("--cap-heads", type=int, default=8)
    ap.add_argument("--fpg", type=int, default=2)
    ap.add_argument("--hps", default=None, help="finetuning HPs yaml")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--metric", default="log_loss")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--time-limit", type=int, default=3600)
    ap.add_argument("--freeze-input", action="store_true", default=True)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--episode-batch", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = cli_device(args.device)

    from multimodalpfn_tpu_torch.hpo.experiment import load_experiment_config
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn
    from multimodalpfn_tpu_torch.utils.logging import setup_logging

    setup_logging()
    hps = {}
    if args.hps:
        hps = load_experiment_config(args.hps)
    if args.steps is not None:
        hps["max_steps"] = args.steps
    if args.lr is not None:
        hps["learning_rate"] = args.lr

    history = fine_tune_mmpfn(
        mixer_type=args.mixer,
        mgm_heads=args.mgm_heads,
        cap_heads=args.cap_heads,
        features_per_group=args.fpg,
        path_to_base_model=args.base,
        save_path_to_fine_tuned_model=args.out,
        time_limit=args.time_limit,
        finetuning_config=hps,
        validation_metric=args.metric,
        task_type=args.task,
        X_train=None if args.x is None else np.load(args.x),
        image_train=None if args.image is None else np.load(args.image),
        y_train=np.load(args.y),
        random_seed=args.seed,
        freeze_input=args.freeze_input,
        episode_batch_size=args.episode_batch,
        resume=args.resume,
        device=device,
    )
    out = {
        "steps": history["steps"],
        "best_val_error": history["best_val_error"],
        "wall_s": round(history["wall_s"], 1),
        "out": str(args.out),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
