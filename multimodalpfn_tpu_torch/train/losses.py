"""Training losses (PyTorch).

Semantics anchors: reference `scripts_finetune_mm/training_utils/training_loss.py:13-85`
and the JAX package's `multimodalpfn_tpu/train/losses.py`: BCE on the
positive-class logit only; CE averaged over (batch, test rows). The
regression loss (the bar distribution's NLL) comes with the regressor, which
the port does not have yet.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def get_loss_fn(task_type: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Returns loss(logits (b, s_test, n_out), y_test (b, s_test)) -> scalar."""
    if task_type == "regression":
        raise NotImplementedError(
            "the regression loss (bar-distribution NLL) is not ported yet: it comes with the regressor"
        )
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
