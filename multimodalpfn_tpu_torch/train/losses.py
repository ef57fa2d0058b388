"""Training losses (PyTorch).

Semantics anchors: reference `scripts_finetune_mm/training_utils/training_loss.py:13-85`
and the JAX package's `multimodalpfn_tpu/train/losses.py`: BCE on the
positive-class logit only; CE averaged over (batch, test rows); for
regression the bar distribution's NLL averaged over (batch, test rows), a NaN
target contributing 0 and still counting in the mean (`losses.py:24-31`). It
differentiates through plain autograd, as JAX differentiates it outside any
kernel.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from multimodalpfn_tpu_torch.models.bar_distribution import FullSupportBarDistribution


def get_loss_fn(
    task_type: str, borders: np.ndarray | None = None
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Returns loss(logits (b, s_test, n_out), y_test (b, s_test)) -> scalar.
    ``borders``: the regression model's bar-distribution borders."""
    if task_type == "regression":
        assert borders is not None
        borders = torch.as_tensor(np.asarray(borders, dtype=np.float32))

        def bar_loss(logits, y):
            bardist = FullSupportBarDistribution(borders.to(logits.device))
            return bardist.nll_loss(logits.float(), y.float()).mean()

        return bar_loss
    if task_type == "binary":

        def bce(logits, y):
            z = logits[..., 1].float()  # positive-class logit (reference `training_loss.py:75`)
            return torch.mean(torch.clamp(z, min=0) - z * y.float() + torch.log1p(torch.exp(-z.abs())))

        return bce
    if task_type == "multiclass":

        def ce(logits, y):
            logp = F.log_softmax(logits.float(), dim=-1)
            return -logp.gather(-1, y.long()[..., None])[..., 0].mean()

        return ce
    raise ValueError(f"Unknown task type: {task_type}")
