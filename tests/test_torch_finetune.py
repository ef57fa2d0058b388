"""The port's fine-tuning (multimodalpfn_tpu_torch/train/) against scikit-learn
1.9.0 and the JAX package, on the CPU in float32.

* The numpy splitters give scikit-learn's indices exactly, and the episode
  stream equals the JAX package's.
* ``log_loss`` and ``accuracy`` equal scikit-learn's; the nine further
  classification scorers equal the JAX registry's exactly (binary and
  6-class labels, float32 and float64 probabilities, tied scores).
* The schedule-free AdamW matches the JAX package's optax chain step for step
  and the NumPy spec of `tests/test_optimizer_spec.py` (frozen leaves, a
  non-finite step, the evaluation point), to that file's tolerances, also
  with ``warmup_steps`` None, 0 and 3 (the spec given optax's warmup);
  so does ``adamw``.
* Whole-model gradients of ``forward_train_test`` + CE match
  ``jax.value_and_grad`` of the JAX package's, on the plain path and on the
  kernel path (whose CPU form runs the plain backwards), to 1e-5 of the
  largest gradient of each leaf.
* A three-step tabular fine-tune's history matches the JAX package's
  ``fine_tune_mmpfn`` to 1e-5; a multimodal fine-tune with dropout writes a
  snapshot the port's classifier serves.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from sklearn.metrics import accuracy_score, log_loss as sk_log_loss
from sklearn.model_selection import KFold, StratifiedKFold, train_test_split

from multimodalpfn_tpu_torch.train import data as tdata
from multimodalpfn_tpu_torch.train import metrics as tmetrics
from multimodalpfn_tpu_torch.train import step as tstep
from tests.test_optimizer_spec import NumpyScheduleFreeAdamW

REL = 1e-5


# ---- splitters -----------------------------------------------------------------


def _labels(seed, n=300):
    rng = np.random.default_rng(seed)
    y = rng.choice(6, size=n, p=[0.5, 0.2, 0.15, 0.1, 0.04, 0.01]).astype(np.float32)
    y[:3] = 5  # a rare class, fewer members than folds
    return y


@pytest.mark.filterwarnings("ignore:The least populated class")
@pytest.mark.parametrize("seed", [0, 1, 7, 4213])
def test_splitters_match_sklearn(seed):
    y = _labels(seed)
    for (a, b), (c, d) in zip(
        StratifiedKFold(10, shuffle=True, random_state=seed).split(y, y),
        tdata.stratified_kfold_split(y, 10, seed),
    ):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    for (a, b), (c, d) in zip(
        KFold(7, shuffle=True, random_state=seed).split(y), tdata.kfold_split(len(y), 7, seed)
    ):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    # a shared RandomState object, as create_val_data passes it
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    tr, te = train_test_split(np.arange(len(y)), test_size=0.2, random_state=r1, stratify=y)
    tr2, te2 = tdata.stratified_train_test_split(y, 0.2, r2)
    np.testing.assert_array_equal(tr, tr2)
    np.testing.assert_array_equal(te, te2)
    assert r1.randint(1 << 30) == r2.randint(1 << 30)


@pytest.mark.filterwarnings("ignore:The least populated class")
def test_episode_stream_matches_jax():
    from multimodalpfn_tpu.train.data import EpisodeSampler as JaxSampler

    y = _labels(3, n=211)
    X = np.zeros((len(y), 2), np.float32)
    js = JaxSampler(X=X, image=None, y=y, is_classification=True)
    ts = tdata.EpisodeSampler(X=X, image=None, y=y, is_classification=True)
    for _ in range(23):  # past one full pass of 10 folds, twice
        want = js.sample_indices(1)
        tr, te = ts.episode_indices()
        np.testing.assert_array_equal(want["train_idx"][0], tr)
        np.testing.assert_array_equal(want["test_idx"][0], te)


# ---- metrics -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_classes", [2, 5])
def test_metrics_match_sklearn(dtype, n_classes):
    rng = np.random.default_rng(n_classes)
    y = rng.integers(0, n_classes, size=97).astype(np.float32)
    y[:n_classes] = np.arange(n_classes)
    p = rng.random((97, n_classes)).astype(dtype)
    p[0, :] = 0.0
    p[0, int(y[0])] = 1.0  # a clipped row
    p /= p.sum(axis=1, keepdims=True)
    assert tmetrics.log_loss(y, p) == sk_log_loss(y, p)
    assert tmetrics.accuracy(y, p) == accuracy_score(y, p.argmax(axis=1))
    scorer = tmetrics.get_scorer("accuracy")
    assert scorer.convert_score_to_error(scorer(y, p)) == 1.0 - accuracy_score(y, p.argmax(axis=1))


NEW_SCORERS = ["balanced_accuracy", "f1", "mcc", "roc_auc", "precision", "recall",
               "quadratic_kappa", "pac", "average_precision"]


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_classes", [2, 6])
@pytest.mark.parametrize("name", NEW_SCORERS)
def test_classification_scorers_match_jax_registry(name, n_classes, dtype, ties):
    """Bit-equal scores (or the same error) to the JAX package's registry,
    which calls scikit-learn 1.9.0; ``ties`` rounds the probabilities so that
    many scores tie (``roc_auc`` ranks them by average ranks)."""
    from multimodalpfn_tpu.train.metrics import get_scorer as jax_scorer

    rng = np.random.default_rng(n_classes + 10 * ties)
    y = rng.integers(0, n_classes, size=97).astype(np.float32)
    y[:n_classes] = np.arange(n_classes)
    p = rng.random((97, n_classes)).astype(dtype)
    if ties:
        p = (np.round(p * 4) / 4 + 0.01).astype(dtype)
    p /= p.sum(axis=1, keepdims=True)
    js, ts = jax_scorer(name), tmetrics.get_scorer(name)
    assert (ts.optimum, ts.greater_is_better, ts.needs_proba) == (js.optimum, js.greater_is_better,
                                                                   js.needs_proba)
    for yy, pp in ((y, p), (y[: n_classes + 30], p[: n_classes + 30])):
        want = js(yy, pp)
        got = ts(yy, pp)
        assert got == want or (np.isnan(got) and np.isnan(want)), (got, want)
        assert ts.convert_score_to_error(got) == js.convert_score_to_error(want)


# ---- optimizer -----------------------------------------------------------------


def _jax_run(tx, params, grad_seq):
    from multimodalpfn_tpu.train.step import TrainState, init_train_state

    state = init_train_state(params, tx)
    out = []
    for g in grad_seq:
        updates, opt_state = tx.update(g, state.opt_state, state.params)
        state = TrainState(optax.apply_updates(state.params, updates), opt_state, state.step + 1)
        out.append(jax.tree.map(np.asarray, state.params))
    return state, out


def _torch_run(params, grad_seq, freeze_input=False, lr=1e-2, **opt):
    state = tstep.init_train_state(
        {k: torch.from_numpy(np.array(v)) for k, v in params.items()} if not isinstance(
            next(iter(params.values())), dict) else
        {k: {n: torch.from_numpy(np.array(w)) for n, w in v.items()} for k, v in params.items()},
        lambda p: tstep.make_optimizer(p, lr, freeze_mask=tstep.frozen_input_mask(p, freeze_input), **opt),
    )
    from multimodalpfn_tpu_torch.models.params import flatten_params

    out = []
    for g in grad_seq:
        flat_p, flat_g = flatten_params(state.params), flatten_params(g)
        for k, p in flat_p.items():
            p.grad = torch.from_numpy(np.array(flat_g[k], np.float32))
        state.optimizer.step()
        out.append({k: v.detach().numpy().copy() for k, v in flatten_params(state.params).items()})
    return state, out


def _assert_tree(got_flat, want_tree, **tol):
    from multimodalpfn_tpu_torch.models.params import flatten_params

    want = flatten_params(want_tree) if isinstance(want_tree, dict) else want_tree
    for k, w in want.items():
        np.testing.assert_allclose(got_flat[k], np.asarray(w), err_msg=k, **tol)


def test_optimizer_matches_optax_step_for_step():
    from multimodalpfn_tpu.train.step import eval_params, make_optimizer

    params = {
        "a": jnp.asarray(np.linspace(-1, 1, 12).reshape(3, 4), jnp.float32),
        "b": jnp.asarray(np.linspace(2, 3, 8).reshape(2, 4), jnp.float32),
    }
    rng = np.random.default_rng(0)
    grads = [
        {k: jnp.asarray(rng.normal(size=v.shape) * s, jnp.float32)
         for (k, v), s in zip(params.items(), (0.02, 30.0 if i % 4 == 1 else 0.05))}
        for i in range(10)
    ]
    jstate, jseq = _jax_run(make_optimizer(1e-2), params, grads)
    tstate, tseq = _torch_run(params, grads)
    for got, want in zip(tseq, jseq):
        _assert_tree(got, want, rtol=2e-5, atol=2e-7)
    ev = tstep.eval_params(tstate)
    _assert_tree({k: v.numpy() for k, v in ev.items()}, eval_params(jstate), rtol=2e-5, atol=2e-7)
    spec = NumpyScheduleFreeAdamW(params, 1e-2)
    for g in grads:
        spec.step(g)
    _assert_tree(tseq[-1], spec.y, rtol=2e-5, atol=2e-7)
    _assert_tree({k: v.numpy() for k, v in ev.items()}, spec.eval_x(), rtol=2e-5, atol=2e-7)


def test_optimizer_frozen_partition_matches_optax():
    """Frozen input encoders stay put and are left out of the clip."""
    from multimodalpfn_tpu.train.step import eval_params, frozen_input_mask, make_optimizer

    params = {
        "encoder": {"w": jnp.ones((4, 2))},
        "layers": {"w": jnp.asarray(np.linspace(0, 1, 8).reshape(4, 2), jnp.float32)},
    }
    rng = np.random.default_rng(1)
    grads = [
        {"encoder": {"w": jnp.asarray(rng.normal(size=(4, 2)), jnp.float32)},
         "layers": {"w": jnp.asarray(rng.normal(size=(4, 2)) * 0.1, jnp.float32)}}
        for _ in range(6)
    ]
    tx = make_optimizer(3e-3, freeze_mask=frozen_input_mask(params, True))
    jstate, jseq = _jax_run(tx, params, grads)
    tstate, tseq = _torch_run(params, grads, freeze_input=True, lr=3e-3)
    for got, want in zip(tseq, jseq):
        _assert_tree(got, want, rtol=2e-5, atol=2e-7)
    np.testing.assert_array_equal(tseq[-1]["encoder/w"], 1.0)
    ev = tstep.eval_params(tstate)
    from multimodalpfn_tpu_torch.models.params import flatten_params

    _assert_tree({k: v.numpy() for k, v in flatten_params(ev).items()}, eval_params(jstate),
                 rtol=2e-5, atol=2e-7)


def test_optimizer_skips_nonfinite_step_like_optax():
    from multimodalpfn_tpu.train.step import make_optimizer

    params = {"w": jnp.asarray([[1.0, -1.0], [0.5, 2.0]], jnp.float32)}
    rng = np.random.default_rng(2)
    gs = [jnp.asarray(rng.normal(size=(2, 2)) * 0.05, jnp.float32) for _ in range(4)]
    seq = [gs[0], gs[1], jnp.asarray([[np.nan, 0], [0, 0]], jnp.float32), gs[2], gs[3]]
    _, jseq = _jax_run(make_optimizer(1e-2), params, [{"w": g} for g in seq])
    tstate, tseq = _torch_run(params, [{"w": g} for g in seq])
    for got, want in zip(tseq, jseq):
        _assert_tree(got, want, rtol=2e-5, atol=2e-7)
    np.testing.assert_array_equal(tseq[2]["w"], tseq[1]["w"])  # the NaN step left no trace
    assert tstate.optimizer.total_notfinite == 1


class _WarmupSpec(NumpyScheduleFreeAdamW):
    """The NumPy spec with optax's linear warmup: the base update at step t
    takes the schedule at t - 1 (its own count), the averaging weight at t
    (the schedule-free count)."""

    def __init__(self, params, lr, warmup_steps):
        super().__init__(params, lr)
        self.peak, self.warmup = lr, warmup_steps

    def step(self, grads):
        sched = (lambda c: self.peak * min(c, self.warmup) / self.warmup) if self.warmup else (lambda c: self.peak)
        grads = {k: np.asarray(g, np.float64) for k, g in grads.items()}
        gnorm = np.sqrt(sum(float((g**2).sum()) for g in grads.values()))
        if gnorm > self.clip_norm:
            grads = {k: g * (self.clip_norm / gnorm) for k, g in grads.items()}
        self.t += 1
        lr_base = sched(self.t - 1)
        self.max_lr = max(self.max_lr, sched(self.t))
        weight = self.max_lr**self.weight_lr_power
        self.weight_sum += weight
        ck = weight / self.weight_sum if self.weight_sum else 0.0
        for k, g in grads.items():
            self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g * g
            nu_hat = self.nu[k] / (1 - self.b2**self.t)
            z_new = self.z[k] - lr_base * g / (np.sqrt(nu_hat) + self.eps)
            x_prev = (self.y[k] - (1 - self.b1) * self.z[k]) / self.b1
            x_new = (1 - ck) * x_prev + ck * z_new
            self.y[k] = self.b1 * x_new + (1 - self.b1) * z_new
            self.z[k] = z_new


def _two_leaves():
    return {
        "a": jnp.asarray(np.linspace(-1, 1, 12).reshape(3, 4), jnp.float32),
        "b": jnp.asarray(np.linspace(2, 3, 8).reshape(2, 4), jnp.float32),
    }


@pytest.mark.parametrize("warmup_steps", [None, 0, 3])
def test_schedule_free_warmup_matches_optax_and_spec(warmup_steps):
    from multimodalpfn_tpu.train.step import eval_params, make_optimizer

    params = _two_leaves()
    rng = np.random.default_rng(3)
    grads = [{k: jnp.asarray(rng.normal(size=v.shape) * s, jnp.float32)
              for (k, v), s in zip(params.items(), (0.02, 30.0 if i == 1 else 0.05))} for i in range(8)]
    jstate, jseq = _jax_run(make_optimizer(1e-2, warmup_steps=warmup_steps), params, grads)
    tstate, tseq = _torch_run(params, grads, warmup_steps=warmup_steps)
    for got, want in zip(tseq, jseq):
        _assert_tree(got, want, rtol=2e-5, atol=2e-7)
    ev = {k: v.numpy() for k, v in tstep.eval_params(tstate).items()}
    _assert_tree(ev, eval_params(jstate), rtol=2e-5, atol=2e-7)
    spec = _WarmupSpec(params, 1e-2, warmup_steps)
    for g in grads:
        spec.step(g)
    _assert_tree(tseq[-1], spec.y, rtol=2e-5, atol=2e-7)
    _assert_tree(ev, spec.eval_x(), rtol=2e-5, atol=2e-7)
    if warmup_steps:  # the base update's lr is 0 at the first step: y stays (to rounding)
        np.testing.assert_allclose(tseq[0]["a"], np.asarray(params["a"]), rtol=0, atol=1e-6)
        assert np.abs(tseq[1]["a"] - tseq[0]["a"]).max() > 1e-4


def test_adamw_matches_optax_step_for_step():
    """``optax.adamw`` inside the JAX package's chain: frozen leaves, the
    clip on the trainable ones, a non-finite step skipped; evaluation at the
    params."""
    from multimodalpfn_tpu.train.step import eval_params, frozen_input_mask, make_optimizer

    params = {"encoder": {"w": jnp.ones((4, 2))},
              "layers": {"w": jnp.asarray(np.linspace(0, 1, 8).reshape(4, 2), jnp.float32),
                         "v": jnp.asarray(np.linspace(-2, 1, 6).reshape(3, 2), jnp.float32)}}
    rng = np.random.default_rng(4)
    grads = [{"encoder": {"w": jnp.asarray(rng.normal(size=(4, 2)), jnp.float32)},
              "layers": {"w": jnp.asarray(rng.normal(size=(4, 2)) * (5.0 if i == 2 else 0.1), jnp.float32),
                         "v": jnp.asarray(rng.normal(size=(3, 2)) * 0.1, jnp.float32)}} for i in range(7)]
    grads[4]["layers"]["v"] = grads[4]["layers"]["v"].at[0, 0].set(jnp.inf)
    tx = make_optimizer(3e-2, optimizer="adamw", freeze_mask=frozen_input_mask(params, True))
    jstate, jseq = _jax_run(tx, params, grads)
    tstate, tseq = _torch_run(params, grads, freeze_input=True, lr=3e-2, optimizer="adamw")
    for got, want in zip(tseq, jseq):
        _assert_tree(got, want, rtol=2e-5, atol=2e-7)
    np.testing.assert_array_equal(tseq[4]["layers/w"], tseq[3]["layers/w"])  # the inf step left no trace
    np.testing.assert_array_equal(tseq[-1]["encoder/w"], 1.0)
    assert tstate.optimizer.total_notfinite == 1 and tstate.optimizer.count == 6
    from multimodalpfn_tpu_torch.models.params import flatten_params

    ev = flatten_params(tstep.eval_params(tstate))
    _assert_tree({k: v.numpy() for k, v in ev.items()}, eval_params(jstate, False), rtol=2e-5, atol=2e-7)
    assert set(tstate.optimizer.state[flatten_params(tstate.params)["layers/w"]]) == {"mu", "nu"}


def test_adamw_train_state_round_trips(tmp_path):
    params = {"w": torch.linspace(-1, 1, 6).reshape(3, 2)}
    st = tstep.init_train_state(params, lambda p: tstep.make_optimizer(p, 1e-2, optimizer="adamw"))
    st.params["w"].grad = torch.ones(3, 2)
    st.optimizer.step()
    st.step = 1
    tstep.save_train_state(tmp_path / "s.npz", st)
    fresh = tstep.init_train_state(params, lambda p: tstep.make_optimizer(p, 1e-2, optimizer="adamw"))
    tstep.restore_train_state(tmp_path / "s.npz", fresh)
    assert fresh.step == 1 and fresh.optimizer.count == 1
    for name in ("mu", "nu"):
        torch.testing.assert_close(fresh.optimizer.state[fresh.params["w"]][name],
                                   st.optimizer.state[st.params["w"]][name], rtol=0, atol=0)
    sf = tstep.init_train_state(params, lambda p: tstep.make_optimizer(p, 1e-2))
    with pytest.raises(ValueError, match="leaves are not the optimizer's"):
        tstep.restore_train_state(tmp_path / "s.npz", sf)


# ---- whole-model gradients -------------------------------------------------------


def _tiny_model(seed=0):
    from multimodalpfn_tpu.models.config import MixerConfig, ModelConfig
    from multimodalpfn_tpu.models.params import init_params

    cfg = ModelConfig(
        emsize=24, nhead=6, nhid_factor=4, nlayers=2, n_out=10, max_num_classes=10,
        mixer=MixerConfig("MGM+CAP", mgm_heads=2, cap_heads=2, in_dim=96),
    )
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(seed), cfg, model_seed=0))
    # the published init zeroes the output projections, which would zero the
    # gradients of everything before them: fill them in
    rng = np.random.default_rng(seed + 1)
    for grp, name in (("attn_feat", "w_out"), ("attn_item", "w_out"), ("mlp", "w2")):
        w = params["layers"][grp][name]
        params["layers"][grp][name] = (rng.standard_normal(w.shape) / np.sqrt(w.shape[-2])).astype(np.float32)
    return cfg, params


def _torch_cfg(jcfg, **kw):
    import dataclasses

    from multimodalpfn_tpu_torch.models.config import MixerConfig, ModelConfig

    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig) if hasattr(jcfg, f.name)}
    d["mixer"] = MixerConfig(**{f.name: getattr(jcfg.mixer, f.name) for f in dataclasses.fields(MixerConfig)})
    return ModelConfig(**{**d, **kw})


@pytest.mark.parametrize("kernel_path", [False, True])
def test_whole_model_grads_match_jax(kernel_path):
    from multimodalpfn_tpu.models.transformer import forward_train_test as jax_fwd
    from multimodalpfn_tpu.train.losses import get_loss_fn as jax_loss
    from multimodalpfn_tpu_torch.models.params import flatten_params, params_from_jax
    from multimodalpfn_tpu_torch.models.transformer import forward_train_test
    from multimodalpfn_tpu_torch.train.losses import get_loss_fn

    jcfg, jparams = _tiny_model()
    rng = np.random.default_rng(5)
    n_tr, n_te, F_ = 37, 11, 5
    x = rng.standard_normal((1, n_tr + n_te, F_)).astype(np.float32)
    img = rng.standard_normal((1, n_tr + n_te, 1, 96)).astype(np.float32)
    y = rng.integers(0, 3, size=(1, n_tr + n_te)).astype(np.float32)
    args = (x[:, :n_tr], y[:, :n_tr], x[:, n_tr:], img[:, :n_tr], img[:, n_tr:])

    def jloss(p):
        logits = jax_fwd(p, jcfg, *map(jnp.asarray, args), train=True, rng=None)
        return jax_loss("multiclass")(logits, jnp.asarray(y[:, n_tr:]))

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jparams))
    jg = flatten_params(jax.tree.map(np.asarray, jg))

    cfg = _torch_cfg(jcfg, fused_ops=kernel_path, use_flash=kernel_path)
    tp = {k: v.requires_grad_(True) for k, v in flatten_params(params_from_jax(jparams)).items()}
    from multimodalpfn_tpu_torch.models.params import unflatten_params

    targs = [torch.from_numpy(a) for a in args]
    logits = forward_train_test(unflatten_params(tp), cfg, targs[0], targs[1], targs[2], targs[3],
                                targs[4], train=True, generator=None)
    loss = get_loss_fn("multiclass")(logits, torch.from_numpy(y[:, n_tr:]))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    assert set(tp) == set(jg)
    for k, want in jg.items():
        got = tp[k].grad.numpy()
        err = np.abs(got - want).max()
        assert err <= REL * np.abs(want).max() + 1e-9, f"{k}: {err} vs {np.abs(want).max()}"


# ---- fine-tune ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """The JAX package's small random base checkpoint (as
    `tests/test_finetune.py` builds it), in the reference torch format."""
    from multimodalpfn_tpu.models.config import MixerConfig, ModelConfig
    from multimodalpfn_tpu.models.loading import save_model
    from multimodalpfn_tpu.models.params import init_params

    path = tmp_path_factory.mktemp("ckpt") / "base.ckpt"
    cfg = ModelConfig(
        emsize=24, nhead=6, nhid_factor=4, nlayers=2, n_out=10, max_num_classes=10,
        mixer=MixerConfig("MGM+CAP", mgm_heads=2, cap_heads=2, in_dim=96),
    )
    save_model(path, init_params(jax.random.PRNGKey(0), cfg, model_seed=0), cfg)
    return path


def test_tabular_finetune_history_matches_jax(tiny_ckpt, tmp_path):
    from multimodalpfn_tpu.datasets.synthetic import toy_classification
    from multimodalpfn_tpu.train.finetune import fine_tune_mmpfn as jax_ft
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn

    X, y = toy_classification(n=100, n_classes=3, nan_share=0.0, seed=0)
    kw = dict(
        mixer_type="none", mgm_heads=2, cap_heads=2, features_per_group=1,
        path_to_base_model=tiny_ckpt,
        finetuning_config={"max_steps": 3, "learning_rate": 3e-3},
        validation_metric="log_loss", task_type="multiclass",
        X_train=X, y_train=y, random_seed=0,
    )
    want = jax_ft(save_path_to_fine_tuned_model=tmp_path / "jax.ckpt", **kw)
    got = fine_tune_mmpfn(save_path_to_fine_tuned_model=tmp_path / "torch.ckpt", device="cpu", **kw)
    assert got["steps"] == want["steps"] == 3
    for key in ("train_loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=REL, err_msg=key)
    assert [s for s, _ in got["val_error"]] == [s for s, _ in want["val_error"]]
    np.testing.assert_allclose([e for _, e in got["val_error"]], [e for _, e in want["val_error"]],
                               rtol=REL)
    np.testing.assert_allclose(got["best_val_error"], want["best_val_error"], rtol=REL)
    assert got["skipped_steps"] == 0
    assert (tmp_path / "torch.ckpt").exists()


def test_multimodal_finetune_with_dropout_is_served(tiny_ckpt, tmp_path):
    from multimodalpfn_tpu_torch import MMPFNClassifier
    from multimodalpfn_tpu_torch.datasets.synthetic import toy_classification
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn

    X, y = toy_classification(n=90, n_classes=3, nan_share=0.0, seed=2)
    img = np.random.default_rng(2).standard_normal((90, 1, 96)).astype(np.float32)
    out = tmp_path / "mm.ckpt"
    hist = fine_tune_mmpfn(
        mixer_type="MGM+CAP", mgm_heads=2, cap_heads=2, features_per_group=1,
        path_to_base_model=tiny_ckpt, save_path_to_fine_tuned_model=out,
        finetuning_config={"max_steps": 2, "learning_rate": 1e-3},
        X_train=X, image_train=img, y_train=y, random_seed=1, device="cpu",
    )
    assert hist["steps"] == 2 and all(np.isfinite(hist["train_loss"]))
    assert np.isfinite(hist["grad_norm"]).all() and hist["skipped_steps"] == 0
    clf = MMPFNClassifier(model_path=out, mixer_type="MGM+CAP", mgm_heads=2, cap_heads=2,
                          n_estimators=2, device="cpu")
    clf.fit(X[:70], img[:70], y[:70])
    proba = clf.predict_proba(X[70:], img[70:])
    assert proba.shape == (20, 3)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-5)


def test_episode_trainer_is_the_fine_tune_loop(tiny_ckpt, tmp_path):
    """`make_episode_trainer` on the fine-tune's own split steps as
    `fine_tune_mmpfn` does (the same losses and gradient norms), and an
    ``nlayers`` override keeps the first layers."""
    from multimodalpfn_tpu_torch.datasets.synthetic import toy_classification
    from multimodalpfn_tpu_torch.train.finetune import (
        create_val_data,
        fine_tune_mmpfn,
        make_episode_trainer,
    )

    X, y = toy_classification(n=100, n_classes=3, nan_share=0.0, seed=0)
    kw = dict(mixer_type="none", mgm_heads=2, cap_heads=2, features_per_group=1,
              path_to_base_model=tiny_ckpt, random_seed=0, device="cpu")
    hist = fine_tune_mmpfn(save_path_to_fine_tuned_model=tmp_path / "ft.ckpt", X_train=X, y_train=y,
                           finetuning_config={"max_steps": 2, "learning_rate": 3e-3}, **kw)
    X_tr, _, _, _, y_tr, _ = create_val_data(X=X, image=None, y=y, rng=np.random.RandomState(0),
                                             is_classification=True)
    trainer = make_episode_trainer(X_train=X_tr, image_train=None, y_train=y_tr,
                                   learning_rate=3e-3, **kw)
    got = [trainer.step() for _ in range(2)]
    np.testing.assert_array_equal([float(m["loss"]) for m in got], hist["train_loss"])
    np.testing.assert_array_equal([float(m["grad_norm"]) for m in got], hist["grad_norm"])

    cut = make_episode_trainer(X_train=X_tr, image_train=None, y_train=y_tr,
                               cfg_override={"nlayers": 1}, **kw)
    assert cut.cfg.nlayers == 1
    assert all(w.shape[0] == 1 for v in cut.state.params["layers"].values() for w in v.values())
    batch = cut.next_batch()
    assert batch["x_train"].shape == (1, cut.sampler.train_size, X.shape[1])
    assert batch["y_test"].shape == (1, cut.sampler.test_size) and "image_train" not in batch
    m = cut.step()
    assert bool(m["applied"]) and np.isfinite(float(m["loss"]))


def test_dropout_draws_come_from_the_generator():
    """Dropout is on only in training with a generator; the same seed gives
    the same masks, another seed others."""
    from multimodalpfn_tpu_torch.models.config import MixerConfig
    from multimodalpfn_tpu_torch.models.mixers import apply_mixer
    from multimodalpfn_tpu_torch.models.params import init_mixer_params

    cfg = MixerConfig("MGM+CAP", mgm_heads=2, cap_heads=2, in_dim=16)
    p = init_mixer_params(torch.Generator().manual_seed(0), cfg, 8)
    img = torch.randn(1, 5, 1, 16, generator=torch.Generator().manual_seed(1))

    def run(seed, train=True):
        return apply_mixer(p, cfg, img, train=train, generator=torch.Generator().manual_seed(seed))

    eval_ = apply_mixer(p, cfg, img)
    torch.testing.assert_close(run(0, train=False), eval_)
    torch.testing.assert_close(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert not torch.equal(run(3), eval_)


def test_finetune_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from multimodalpfn_tpu_torch.train.finetune import fine_tune_mmpfn

    with pytest.raises(RuntimeError, match='device="cpu"'):
        fine_tune_mmpfn(mixer_type="none", mgm_heads=2, cap_heads=2, features_per_group=1,
                        save_path_to_fine_tuned_model="unused.ckpt", y_train=np.zeros(4))
