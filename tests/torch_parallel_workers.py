"""Rank functions of the port's multi-rank CPU tests
(`test_torch_parallel.py`, `test_torch_ring_attention.py`,
`test_torch_multidevice.py`), run by `parallel.launch.run_ranks` in gloo
processes of one torch thread each. This module imports no JAX: the JAX
side of each comparison runs in the pytest process. Inputs are drawn from
numpy seeds the tests share; every function returns numpy arrays."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from multimodalpfn_tpu_torch.models.config import MixerConfig, ModelConfig
from multimodalpfn_tpu_torch.models.params import flatten_params, params_from_jax, unflatten_params
from multimodalpfn_tpu_torch.parallel.mesh import (
    full_grad,
    gather_tree,
    make_mesh,
    param_shardings,
    set_mesh,
    shard_axis,
    shard_params,
)
from multimodalpfn_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_attention_sharded_queries,
)

# the JAX ring tests' shapes: (B, h, Sq, Skv, d), the sharded variant's Sq,
# the flash case's shapes
RING_QKV = (2, 3, 40, 64, 16)
RING_SQ_SHARDED = 32
FLASH_QKV = (1, 2, 24, 1024, 16)
# the encoder layer cases: (seed, b, t) and (sep, test rows)
LAYER_FWD, LAYER_GRAD, LAYER_ROWS = (5, 2, 5), (6, 2, 3), (64, 24)
# the training step: seed, (b, train rows, test rows, features)
STEP_SEED, STEP_DIMS = 8, (1, 64, 16, 3)


def cfg_from_dict(d: dict, **kw) -> ModelConfig:
    d = dict(d)
    return dataclasses.replace(ModelConfig(mixer=MixerConfig(**d.pop("mixer")), **d), **kw)


def ring_qkv(dims=RING_QKV, seed: int = 0):
    B, h, Sq, Skv, d = dims
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32) for s in ((B, h, Sq, d), (B, h, Skv, d), (B, h, Skv, d)))


def flash_inputs():
    """The JAX flash ring test's q, k, v and cotangent, from one generator."""
    B, h, Sq, Skv, d = FLASH_QKV
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((B, h, Sq, d), (B, h, Skv, d), (B, h, Skv, d)))
    return q, k, v, rng.standard_normal(q.shape).astype(np.float32)


def layer_input(seed: int, b: int, t: int, e: int) -> np.ndarray:
    sep, s_test = LAYER_ROWS
    return np.random.default_rng(seed).normal(size=(b, sep + s_test, t, e)).astype(np.float32)


def step_data():
    b, s_tr, s_te, F = STEP_DIMS
    rng = np.random.default_rng(STEP_SEED)
    x_tr = rng.normal(size=(b, s_tr, F)).astype(np.float32)
    y_tr = rng.integers(0, 3, size=(b, s_tr)).astype(np.float32)
    x_te = rng.normal(size=(b, s_te, F)).astype(np.float32)
    y_te = rng.integers(0, 3, size=(b, s_te)).astype(np.float32)
    return x_tr, y_tr, x_te, y_te


def _t(a, grad: bool = False) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32, requires_grad=grad)


def _grads(f, *args) -> tuple[np.ndarray, list[np.ndarray]]:
    ts = [_t(a, grad=True) for a in args]
    out = f(*ts)
    out.backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _np(tree: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in flatten_params(tree).items()}


# --- test_torch_parallel.py --------------------------------------------------


def all_reduce_rank(rank: int, world: int) -> float:
    """One all-reduce of ``rank + 1`` over the world."""
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    assert dist.get_world_size() == world and dist.get_rank() == rank
    return float(t.item())


def shardings_and_gathers(rank: int, world: int, trees: dict) -> dict:
    """`param_shardings` of each model at mp 1, 2, 4, and whether every
    model's shards gather back to its params bit for bit."""
    out = {}
    for mp in (1, 2, 4):
        mesh = make_mesh(mp=mp)
        for name, tree in trees.items():
            params = params_from_jax(tree)
            out[name, mp] = flatten_params(param_shardings(params, mesh))
            shards = shard_params(params, mesh)
            with set_mesh(mesh):
                back = gather_tree(shards)
            out[name, mp, "gathered"] = all(torch.equal(a, b) for a, b in
                                            zip(flatten_params(back).values(), flatten_params(params).values()))
            out[name, mp, "shard_shapes"] = {k: tuple(v.shape) for k, v in flatten_params(shards).items()}
    return out


# --- test_torch_ring_attention.py --------------------------------------------


def ring_checks(rank: int, world: int, layer_tree: dict, layer_cfg: dict, model_tree: dict,
                model_cfg: dict) -> dict:
    """The seven JAX ring tests' port cases on this rank. Ring over ``dp``
    of the whole world (the flash case: ``dp`` = 2 of a ``(2, 2)`` mesh)."""
    from multimodalpfn_tpu_torch.models.transformer import encoder_layer, forward_train_test
    from multimodalpfn_tpu_torch.train.losses import get_loss_fn

    mesh = make_mesh()
    out: dict = {}
    q, k, v = ring_qkv()
    qs = q[:, :, :RING_SQ_SHARDED]
    with torch.no_grad():
        out["fwd"] = ring_attention(_t(q), _t(k), _t(v), mesh=mesh).numpy()
        out["fwd_sharded"] = ring_attention_sharded_queries(_t(qs), _t(k), _t(v), mesh=mesh).numpy()
    cot = _t(np.random.default_rng(7).standard_normal(q.shape))
    _, out["grads"] = _grads(lambda a, b, c: (ring_attention(a, b, c, mesh=mesh) * cot).sum(), q, k, v)
    # the sharded variant's loss is each rank's block's: their sum is the JAX loss
    with set_mesh(mesh):
        _, out["grads_sharded"] = _grads(
            lambda a, b, c: (ring_attention_sharded_queries(a, b, c) ** 2).sum(), qs, k, v)

    cfg = cfg_from_dict(layer_cfg)
    ring_cfg = dataclasses.replace(cfg, seq_shard_axis="dp")
    lp = params_from_jax(layer_tree)
    sep = LAYER_ROWS[0]
    x = _t(layer_input(*LAYER_FWD, cfg.emsize))
    with set_mesh(mesh), torch.no_grad():
        out["layer"] = encoder_layer(x, lp, single_eval_pos=sep, cfg=ring_cfg).numpy()
        out["layer_unsharded"] = encoder_layer(x, lp, single_eval_pos=sep, cfg=cfg).numpy()
    x = _t(layer_input(*LAYER_GRAD, cfg.emsize))
    leaves = {k: v.requires_grad_(True) for k, v in flatten_params(lp).items()}
    with set_mesh(mesh):
        loss = (encoder_layer(x, unflatten_params(leaves), single_eval_pos=sep, cfg=ring_cfg) ** 2).sum()
    loss.backward()
    out["layer_grads"] = {k: v.grad.numpy() for k, v in leaves.items()}

    mcfg = cfg_from_dict(model_cfg, seq_shard_axis="dp")
    params = {k: v.requires_grad_(True) for k, v in flatten_params(params_from_jax(model_tree)).items()}
    x_tr, y_tr, x_te, y_te = (torch.from_numpy(a) for a in step_data())
    with set_mesh(mesh):
        logits = forward_train_test(unflatten_params(params), mcfg, x_tr, y_tr, x_te)
        loss = get_loss_fn("multiclass")(logits, y_te)
    loss.backward()
    out["step_loss"] = float(loss.item())
    out["step_grads"] = {k: v.grad.numpy() for k, v in params.items()}

    mesh2 = make_mesh(mp=2)  # a ring of 2 over dp: 2 blocks of 512 rows
    q, k, v, cot = flash_inputs()
    cot = _t(cot)
    out["flash_loss"], out["flash_grads"] = _grads(
        lambda a, b, c: (ring_attention(a, b, c, mesh=mesh2, use_flash=True) * cot).sum(), q, k, v)
    return out


# --- test_torch_multidevice.py -----------------------------------------------


def sweep_kwargs(ckpt: str, data) -> dict:
    X, img, y = data
    return dict(cells=[{"mgm_heads": 2, "cap_heads": 2, "seeds": [0, 1]},
                       {"mgm_heads": 4, "cap_heads": 2, "seeds": [0, 1]}],
                mixer_type="MGM+CAP", features_per_group=1, path_to_base_model=ckpt, X=X, image=img, y=y,
                finetuning_config={"max_steps": 3}, device="cpu")


def sweep_result(out: dict) -> dict:
    h = out["history"]
    return {"train_loss": np.asarray(h["train_loss"]), "val_error": h["val_error"],
            "best_val_error": h["best_val_error"], "skipped_steps": h["skipped_steps"],
            "n_step_seconds": len(h["step_seconds"]), "params": _np(out["params_stacked"])}


def estimator_answers(kind: str, ckpt: str, data, mesh=None) -> np.ndarray:
    """A fitted classifier's probabilities or a regressor's means, served from
    tensor-parallel shards under ``mesh`` when one is given."""
    from multimodalpfn_tpu_torch import MMPFNClassifier, MMPFNRegressor
    from multimodalpfn_tpu_torch.parallel.mesh import shard_estimator

    X_tr, img_tr, y_tr, X_te, img_te = data
    cls = MMPFNClassifier if kind.startswith("classifier") else MMPFNRegressor
    fit_mode = "fit_with_cache" if kind.endswith("cache") else "fit_preprocessors"
    est = cls(model_path=ckpt, mgm_heads=2, cap_heads=2, n_estimators=2, random_state=0, device="cpu",
              fit_mode=fit_mode).fit(X_tr, img_tr, y_tr)
    if mesh is not None:
        shard_estimator(est, mesh)
        assert any(shard_axis(v) is not None for v in flatten_params(est.params_).values())
    with set_mesh(mesh):
        return est.predict_proba(X_te, img_te) if cls is MMPFNClassifier else est.predict(X_te, img_te)


def step_model():
    from multimodalpfn_tpu_torch.models.params import init_params

    cfg = ModelConfig(emsize=32, nhead=4, nhid_factor=2, nlayers=2, n_out=4, max_num_classes=4,
                      compute_dtype="float32", mixer=MixerConfig("MGM+CAP", mgm_heads=2, cap_heads=2, in_dim=64))
    return cfg, init_params(torch.Generator().manual_seed(11), cfg)


def step_batch() -> dict:
    rng = np.random.default_rng(12)
    b, s_tr, s_te, F = 2, 24, 8, 3
    batch = {"x_train": rng.normal(size=(b, s_tr, F)), "y_train": rng.integers(0, 3, size=(b, s_tr)),
             "x_test": rng.normal(size=(b, s_te, F)), "y_test": rng.integers(0, 3, size=(b, s_te)),
             "image_train": rng.normal(size=(b, s_tr, 1, 64)), "image_test": rng.normal(size=(b, s_te, 1, 64))}
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in batch.items()}


def train_step_result(mesh=None) -> dict:
    """One schedule-free step of `step_model` on `step_batch`: the loss, the
    gradient norm, every gradient and the params after the step (whole
    leaves); with a ``mesh``, the params are sharded over its ``mp`` axis."""
    from multimodalpfn_tpu_torch.train.losses import get_loss_fn
    from multimodalpfn_tpu_torch.train.step import init_train_state, make_optimizer, make_train_step

    cfg, params = step_model()
    if mesh is not None:
        params = shard_params(params, mesh)
    state = init_train_state(params, lambda p: make_optimizer(p, 1e-3))
    if mesh is not None:  # the optimizer steps shards
        assert any(shard_axis(v) is not None for v in flatten_params(state.params).values())
    step = make_train_step(cfg, get_loss_fn("multiclass"), mesh)
    state, m = step(state, step_batch(), None)
    with set_mesh(mesh), torch.no_grad():
        grads = {k: full_grad(p).numpy().copy() for k, p in flatten_params(state.params).items()}
        after = _np(gather_tree(state.params))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "applied": m["applied"],
            "grads": grads, "params": after}


def multidevice_checks(rank: int, world: int, mesh_ckpt: str, mesh_data, sweep_ckpt: str, sweep_data,
                       clf_ckpt: str, reg_ckpt: str, clf_data, reg_data) -> dict:
    """On 4 ranks: `fine_tune_batched` over ``dp`` = 4 (the JAX mesh test's
    case), then on a ``(2, 2)`` mesh the sweep over ``dp``, the estimators
    served from ``mp`` shards, and one ``dp × mp`` training step."""
    from multimodalpfn_tpu_torch.train.finetune_batch import fine_tune_batched, fine_tune_batched_cells

    out: dict = {}
    X, emb, y = mesh_data
    h = fine_tune_batched(mixer_type="MGM+CAP", mgm_heads=2, cap_heads=2, features_per_group=1,
                          path_to_base_model=mesh_ckpt, X=X, image=emb, y=y, seeds=[0, 1, 2, 3],
                          finetuning_config={"max_steps": 2, "validate_every_n_steps": 2},
                          mesh=make_mesh(), device="cpu")["history"]
    out["mesh_history"] = {"train_loss": np.asarray(h["train_loss"]), "val_error": h["val_error"],
                           "best_val_error": h["best_val_error"]}
    mesh = make_mesh(mp=2)
    out["sweep"] = sweep_result(fine_tune_batched_cells(mesh=mesh, **sweep_kwargs(sweep_ckpt, sweep_data)))
    for kind, ckpt, data in (("classifier", clf_ckpt, clf_data), ("classifier_cache", clf_ckpt, clf_data),
                             ("regressor", reg_ckpt, reg_data)):
        out[kind] = (estimator_answers(kind, ckpt, data), estimator_answers(kind, ckpt, data, mesh))
    out["step"] = train_step_result(mesh)
    return out
