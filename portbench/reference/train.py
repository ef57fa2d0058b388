"""The reference fine-tune: the first steps of the published protocol
(too-z/MultiModalPFN `scripts_finetune_mm/finetune_mmpfn_main.py`): a 20 %
validation split, one K-fold episode a step (the frozen copy of the
program's splitters, `episodes.py`), the mixer's dropout, the test fold's
loss (cross-entropy), the global gradient
norm clipped to 1, schedule-free AdamW (Defazio et al. 2024; weight decay
0, no warmup), the encoders frozen, and validation at the schedule-free
evaluation point. Float32 with plain autograd (TF32 off)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model
from portbench.reference.episodes import EpisodeSampler, stratified_train_test_split

B1, B2, EPS, MAX_GRAD_NORM = 0.9, 0.999, 1e-8, 1.0
FROZEN = ("encoder/", "y_encoder/")


def val_split(X, image, y, seed: int):
    """The 20 % validation split of ``RandomState(seed)`` (scikit-learn's
    ``train_test_split``, stratified)."""
    tr, va = stratified_train_test_split(y, 0.2, np.random.RandomState(seed))
    return (X[tr], image[tr], np.asarray(y[tr], np.float32)), (X[va], image[va], np.asarray(y[va], np.float32))


def loss_fn(logits, y):
    return -torch.log_softmax(logits, dim=-1).gather(-1, y.long()[:, None])[:, 0].mean()


class ScheduleFreeAdamW:
    """Per step t with the clipped gradient g: ν ← b2·ν + (1−b2)·g²;
    z' = z − lr·g / (sqrt(ν / (1 − b2^t)) + eps); c = 1/t (weights lr²);
    x = (y − (1−b1)·z) / b1; y ← b1·((1−c)·x + c·z') + (1−b1)·z'."""

    def __init__(self, params: dict, lr: float):
        self.lr, self.t = lr, 0
        self.z = {k: p.detach().clone() for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c = 1.0 / self.t
        for k, p in params.items():
            g = grads[k]
            self.nu[k] = B2 * self.nu[k] + (1 - B2) * g * g
            z_new = self.z[k] - self.lr * g / (torch.sqrt(self.nu[k] / (1 - B2 ** self.t)) + EPS)
            x = (p - (1 - B1) * self.z[k]) / B1
            p.copy_(B1 * ((1 - c) * x + c * z_new) + (1 - B1) * z_new)
            self.z[k] = z_new

    @torch.no_grad()
    def eval_point(self, k: str, p: torch.Tensor) -> torch.Tensor:
        return (p - (1 - B1) * self.z[k]) / B1 if k in self.z else p.detach()


def fine_tune_steps(weights: dict, arch: dict, data: dict, *, seed: int, lr: float, n_steps: int,
                    device, precision: str = "float32") -> dict:
    """``n_steps`` steps from ``weights`` on ``data`` (the fine-tune's own
    split: ``train`` and ``val`` triples of X, image, y) with the dropout
    generator seeded ``seed`` on ``device``. Returns each step's loss, each
    trainable leaf's clipped first gradient and its change after the steps
    (norms), and the validation logits at the evaluation point."""
    X_tr, img_tr, y_tr = data["train"]
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    train = {k: p for k, p in params.items() if not k.startswith(FROZEN)}
    opt = ScheduleFreeAdamW(train, lr)
    sampler = EpisodeSampler(X=X_tr, image=img_tr, y=y_tr)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    losses, first_grad = [], None
    for _ in range(n_steps):
        tr, te = sampler.episode_indices()
        rows = np.concatenate([tr, te])
        logits = model.forward(params, arch, dev(X_tr[rows]), dev(y_tr[tr]), dev(img_tr[rows]),
                               precision=precision, gen=gen, checkpoint_layers=True)
        loss = loss_fn(logits, dev(y_tr[te]))
        grads = torch.autograd.grad(loss, list(train.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(train.items(), grads)}
        gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        if not bool(gnorm < MAX_GRAD_NORM):
            grads = {k: g / gnorm * MAX_GRAD_NORM for k, g in grads.items()}
        if first_grad is None:
            first_grad = {k: float(g.double().norm()) for k, g in grads.items()}
        opt.step(train, grads)
        losses.append(float(loss.detach()))
    change = {k: float((p.detach().double() - weights[k].double()).norm()) for k, p in train.items()}
    X_va, img_va, _ = data["val"]
    with torch.no_grad():
        ev = {k: opt.eval_point(k, p) for k, p in params.items()}
        val = model.forward(ev, arch, dev(np.concatenate([X_tr, X_va])), dev(y_tr),
                            dev(np.concatenate([img_tr, img_va])), precision=precision)
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "val_logits": val.double().cpu().numpy()}
