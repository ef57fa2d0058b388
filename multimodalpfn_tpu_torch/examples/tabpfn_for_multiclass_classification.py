"""Multiclass classification with TabPFNClassifier (cf. reference
`models/mmpfn/examples/tabpfn_for_multiclass_classification.py`); the port of
the JAX package's example.

The card's machine has no scikit-learn, so the data is not scikit-learn's
iris set but a synthetic set of its shape (150 rows, 4 numeric features, 3
classes) from `datasets/synthetic.py`; the split is the port's copy of
``train_test_split(test_size=0.33, random_state=42)`` (`train/data.py`) and
the scores its copies of ``roc_auc_score(multi_class="ovo")`` and
``accuracy_score`` (`train/metrics.py`)."""

from __future__ import annotations

from multimodalpfn_tpu_torch import TabPFNClassifier
from multimodalpfn_tpu_torch.datasets.synthetic import toy_classification
from multimodalpfn_tpu_torch.train.data import train_test_split_indices
from multimodalpfn_tpu_torch.train.metrics import accuracy, roc_auc


def main(model_path: str = "auto", device: str = "cuda") -> dict:
    X, y = toy_classification(n=150, n_features=4, n_classes=3, n_categorical=0, nan_share=0.0, seed=0)
    tr, te = train_test_split_indices(len(y), test_size=0.33, random_state=42)

    # model_path="auto" loads the published tabpfn-v2-classifier.ckpt from the model
    # cache; "random:0" runs the architecture with fresh weights (for smoke tests).
    clf = TabPFNClassifier(model_path=model_path, device=device)
    clf.fit(X[tr], y[tr])

    proba = clf.predict_proba(X[te])
    out = {"roc_auc_ovo": roc_auc(y[te], proba), "accuracy": accuracy(y[te], proba)}
    print("ROC AUC (ovo):", out["roc_auc_ovo"])
    print("Accuracy:", out["accuracy"])
    return out


if __name__ == "__main__":
    main()
