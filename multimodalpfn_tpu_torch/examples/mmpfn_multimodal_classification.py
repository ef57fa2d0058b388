"""Multimodal classification: tabular features + frozen image embeddings fused via
the MGM+CAP mixer (the reference's PAD-UFES-20 workflow, `mmpfn/run.py`); the
port of the JAX package's `examples/mmpfn_multimodal_classification.py`."""

from __future__ import annotations

import numpy as np

from multimodalpfn_tpu_torch import MMPFNClassifier
from multimodalpfn_tpu_torch.datasets.synthetic import toy_multimodal_classification
from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn


def main(
    model_path: str = "auto",  # or "random:0" without the published ckpt
    device: str = "cuda",
    *,
    max_steps: int = 100,
    features_per_group: int = 2,  # the base checkpoint's own
) -> dict:
    X, emb, y = toy_multimodal_classification(n=200, n_classes=3, emb_dim=768, seed=0)
    ntr = 160
    save_path = "checkpoints/finetuned_example.ckpt"

    # 1) briefly fine-tune the mixers on the downstream data (frozen input encoders)
    fine_tune_mmpfn(
        mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8, features_per_group=features_per_group,
        path_to_base_model=model_path,
        save_path_to_fine_tuned_model=save_path,
        finetuning_config={"learning_rate": 1e-5, "max_steps": max_steps},
        validation_metric="log_loss", task_type="multiclass",
        X_train=X[:ntr], image_train=emb[:ntr], y_train=y[:ntr], freeze_input=True,
        device=device,
    )

    # 2) fit/predict with the fine-tuned checkpoint
    clf = MMPFNClassifier(
        model_path=save_path,
        mixer_type="MGM+CAP", mgm_heads=16, cap_heads=8, features_per_group=features_per_group,
        device=device,
    )
    clf.fit(X[:ntr], emb[:ntr], y[:ntr])
    accuracy = float(np.mean(clf.predict(X[ntr:], emb[ntr:]) == y[ntr:]))
    print("accuracy:", accuracy)
    return {"accuracy": accuracy}


if __name__ == "__main__":
    main()
