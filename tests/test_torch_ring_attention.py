"""The port's ring attention (`parallel/ring_attention.py`) and its call
sites, on four gloo ranks (`parallel/launch.run_ranks`, one torch thread a
rank), against the JAX package's ring on ``make_mesh(4)`` of the 8 virtual
CPU devices and against plain attention: the port of each of the seven JAX
ring tests (`tests/test_ring_attention.py`), at their tolerances.

* `ring_attention` (replicated queries) and
  `ring_attention_sharded_queries`: forward 2e-5 / 2e-6, gradients 2e-4 /
  2e-5 (the sharded variant's blocks concatenated over the ranks);
* ``use_flash`` with 2 × 512-row shards (a ring of 2 over ``dp`` of a
  ``(2, 2)`` mesh) through the plain versions of K4 and K11, against the JAX
  ring through the Pallas kernels in interpret mode: loss 2e-4, gradients
  3e-4 / 3e-5;
* the encoder layer with ``seq_shard_axis="dp"`` against the JAX package's
  unsharded ``encoder_layer`` (forward 2e-5 / 2e-5; every parameter's
  gradient 3e-4 / 3e-5): the check that catches a wrong transpose of the
  K/V cut, on params with every leaf perturbed (the JAX test's zero output
  projections leave the K/V projection's gradient zero, which hides it);
* a 2-layer training step with ``seq_shard_axis="dp"`` against the JAX
  package's unsharded step: loss 1e-5 / 1e-6, gradients 5e-4 / 5e-5.

Every rank's replicated result is checked, not only rank 0's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
from multimodalpfn_tpu.models.params import init_params as jinit_params
from multimodalpfn_tpu.models.transformer import encoder_layer as jencoder_layer
from multimodalpfn_tpu.models.transformer import forward_train_test as jforward_train_test
from multimodalpfn_tpu.parallel.mesh import make_mesh as jmake_mesh
from multimodalpfn_tpu.parallel.ring_attention import ring_attention as jring
from multimodalpfn_tpu.parallel.ring_attention import ring_attention_sharded_queries as jring_sq
from multimodalpfn_tpu.train.losses import get_loss_fn as jget_loss_fn
from multimodalpfn_tpu_torch.parallel.launch import run_ranks
from tests import torch_parallel_workers as w

RANKS = 4
LAYER_CFG = JModelConfig(emsize=48, nhead=4, nhid_factor=2, nlayers=1, n_out=4, compute_dtype="float32")
MODEL_CFG = JModelConfig(emsize=48, nhead=4, nhid_factor=2, nlayers=2, features_per_group=1, n_out=4,
                         max_num_classes=4, compute_dtype="float32")


def _ref(q, k, v, scale):
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)


def _flat(tree) -> dict:
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _densified(tree, seed: int):
    """Every leaf perturbed: the initialization's zero output projections
    would leave the item attention out of the layer's value, and so its
    K/V projection's gradient (the one a wrong transpose of the K/V cut
    changes) exactly zero in both packages."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def trees():
    layer = jax.device_get(jax.tree.map(lambda a: a[0], jinit_params(jax.random.PRNGKey(0), LAYER_CFG,
                                                                     model_seed=0)["layers"]))
    model = jax.device_get(jinit_params(jax.random.PRNGKey(0), MODEL_CFG, model_seed=0))
    return _densified(layer, 1), _densified(model, 2)


@pytest.fixture(scope="module")
def port(trees, tmp_path_factory):
    """Every rank's results."""
    layer, model = trees
    return run_ranks(w.ring_checks, RANKS, layer, dataclasses.asdict(LAYER_CFG), model,
                     dataclasses.asdict(MODEL_CFG), workdir=tmp_path_factory.mktemp("ring"), timeout=300)


@pytest.fixture(scope="module")
def qkv():
    return tuple(jnp.asarray(a) for a in w.ring_qkv())


def _scale(q):
    return 1.0 / np.sqrt(q.shape[-1])


def test_ring_attention_matches_jax_and_reference(port, qkv):
    q, k, v = qkv
    mesh = jmake_mesh(RANKS, mp=1)
    want_jax = np.asarray(jring(q, k, v, mesh=mesh))
    want = np.asarray(_ref(q, k, v, _scale(q)))
    for out in port:
        np.testing.assert_allclose(out["fwd"], want_jax, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(out["fwd"], want, rtol=2e-5, atol=2e-6)


def test_ring_attention_sharded_queries_matches_jax_and_reference(port, qkv):
    q, k, v = qkv
    q = q[:, :, : w.RING_SQ_SHARDED]
    got = np.concatenate([out["fwd_sharded"] for out in port], axis=2)
    np.testing.assert_allclose(got, np.asarray(jring_sq(q, k, v, mesh=jmake_mesh(RANKS, mp=1))),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, np.asarray(_ref(q, k, v, _scale(q))), rtol=2e-5, atol=2e-6)


def _assert_grads(got, wants, rtol, atol):
    for want in wants:
        for a, b, name in zip(got, want, ("dq", "dk", "dv")):
            np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=name)


def test_ring_attention_grads_match_jax_and_reference(port, qkv):
    q, k, v = qkv
    mesh = jmake_mesh(RANKS, mp=1)
    cot = jnp.asarray(np.random.default_rng(7).standard_normal(q.shape), jnp.float32)
    g_ring = jax.grad(lambda *a: jnp.sum(jring(*a, mesh=mesh) * cot), argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(lambda *a: jnp.sum(_ref(*a, _scale(q)) * cot), argnums=(0, 1, 2))(q, k, v)
    for out in port:
        _assert_grads(out["grads"], (g_ring, g_ref), 2e-4, 2e-5)


def test_ring_attention_sharded_queries_grads_match_jax_and_reference(port, qkv):
    q, k, v = qkv
    q = q[:, :, : w.RING_SQ_SHARDED]
    mesh = jmake_mesh(RANKS, mp=1)
    g_ring = jax.grad(lambda *a: jnp.sum(jring_sq(*a, mesh=mesh) ** 2), argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(lambda *a: jnp.sum(_ref(*a, _scale(q)) ** 2), argnums=(0, 1, 2))(q, k, v)
    for out in port:
        _assert_grads(out["grads_sharded"], (g_ring, g_ref), 2e-4, 2e-5)


def test_ring_attention_flash_path_grads(port):
    """Two 512-row shards through K4's and K11's plain versions against the
    JAX ring through the Pallas flash kernels (interpret mode)."""
    q, k, v, cot = (jnp.asarray(a) for a in w.flash_inputs())
    mesh = jmake_mesh(2, mp=1)

    def loss_ring(*a):
        return jnp.sum(jring(*a, mesh=mesh, use_flash=True) * cot)

    with pltpu.force_tpu_interpret_mode():
        l_ring, g_ring = jax.value_and_grad(loss_ring, argnums=(0, 1, 2))(q, k, v)
    l_ref, g_ref = jax.value_and_grad(lambda *a: jnp.sum(_ref(*a, _scale(q)) * cot), argnums=(0, 1, 2))(q, k, v)
    for out in port:
        np.testing.assert_allclose(float(out["flash_loss"]), float(l_ring), rtol=2e-4)
        np.testing.assert_allclose(float(out["flash_loss"]), float(l_ref), rtol=2e-4)
        _assert_grads(out["flash_grads"], (g_ring, g_ref), 3e-4, 3e-5)


def test_encoder_layer_with_seq_shard_axis_matches_jax(port, trees):
    layer, _ = trees
    x = jnp.asarray(w.layer_input(*w.LAYER_FWD, LAYER_CFG.emsize))
    want = np.asarray(jencoder_layer(x, jax.tree.map(jnp.asarray, layer), single_eval_pos=w.LAYER_ROWS[0],
                                     cfg=LAYER_CFG))
    for out in port:
        np.testing.assert_allclose(out["layer"], want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(out["layer_unsharded"], want, rtol=2e-5, atol=2e-5)


def test_encoder_layer_grad_with_seq_shard_axis(port, trees):
    layer, _ = trees
    x = jnp.asarray(w.layer_input(*w.LAYER_GRAD, LAYER_CFG.emsize))

    def loss(lp):
        return jnp.sum(jencoder_layer(x, lp, single_eval_pos=w.LAYER_ROWS[0], cfg=LAYER_CFG) ** 2)

    want = _flat(jax.grad(loss)(jax.tree.map(jnp.asarray, layer)))
    for out in port:
        assert set(out["layer_grads"]) == set(want)
        for key, g in out["layer_grads"].items():
            np.testing.assert_allclose(g, want[key], rtol=3e-4, atol=3e-5, err_msg=key)


def test_finetune_step_with_seq_shard_axis(port, trees):
    _, model = trees
    x_tr, y_tr, x_te, y_te = (jnp.asarray(a) for a in w.step_data())
    loss_fn = jget_loss_fn("multiclass")

    def compute_loss(p):
        return loss_fn(jforward_train_test(p, MODEL_CFG, x_tr, y_tr, x_te), y_te)

    want_loss, want_g = jax.value_and_grad(compute_loss)(jax.tree.map(jnp.asarray, model))
    want_g = _flat(want_g)
    for out in port:
        np.testing.assert_allclose(out["step_loss"], float(want_loss), rtol=1e-5, atol=1e-6)
        assert set(out["step_grads"]) == set(want_g)
        for key, g in out["step_grads"].items():
            np.testing.assert_allclose(g, want_g[key], rtol=5e-4, atol=5e-5, err_msg=key)
