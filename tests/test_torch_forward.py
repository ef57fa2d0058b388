"""The port's forward (multimodalpfn_tpu_torch/models/transformer.py) against
the JAX package's forward on the same weights, and against the original
PyTorch reference through the golden fixtures; plus the param bridges.

Both of the port's paths run here: the plain sample-major layers
(``fused_ops=False``) and the item-major kernel path (``fused_ops=True``),
whose wrappers run their plain versions on the CPU.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multimodalpfn_tpu.models import params as jparams
from multimodalpfn_tpu.models.config import MixerConfig as JMixerConfig
from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
from multimodalpfn_tpu.models.transformer import forward as jforward
from multimodalpfn_tpu_torch.models import params as tparams
from multimodalpfn_tpu_torch.models.config import MixerConfig, ModelConfig
from multimodalpfn_tpu_torch.models.loading import load_npz, save_npz
from multimodalpfn_tpu_torch.models.transformer import forward
from tests.golden_utils import GOLDEN_DIR, GoldenCase

GOLDEN = sorted(p.stem for p in GOLDEN_DIR.glob("*.npz"))
# float32 graphs with different op orderings on both sides; the JAX package's
# own golden parity bound (tests/test_forward_parity.py:28)
TOL = dict(rtol=2e-4, atol=2e-5)
PATHS = {"plain": dict(fused_ops=False), "kernels": dict(fused_ops=True, use_flash=True)}


def to_port_config(cfg: JModelConfig, **kw) -> ModelConfig:
    d = dataclasses.asdict(cfg)
    mixer = MixerConfig(**d.pop("mixer"))
    return dataclasses.replace(ModelConfig(mixer=mixer, **d), **kw)


def jax_param_tree(cfg: JModelConfig, seed: int) -> dict:
    """JAX init as numpy leaves, with the zero-initialized output projections
    filled in so attention and MLP actually contribute."""
    tree = jax.device_get(jparams.init_params(jax.random.PRNGKey(seed), cfg, model_seed=cfg.model_seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree
    )


def _inputs(seed, b=2, S=50, sep=35, F=5, n_img=1, in_dim=64, n_classes=5, image=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, S, F)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    y = rng.integers(0, n_classes, size=(b, sep)).astype(np.float32)
    img = rng.normal(size=(1, S, n_img, in_dim)).astype(np.float32) if image else None
    return x, y, img


MIXERS = {
    "mgm_cap": JMixerConfig(mixer_type="MGM+CAP", mgm_heads=2, cap_heads=4, in_dim=64),
    "mgm_only": JMixerConfig(mixer_type="MGM", mgm_heads=2, cap_heads=4, in_dim=64),
    "tabular": JMixerConfig(),
    # PetFinder's image+text shape (portbench's mmpfn-clf-petfinder-mgmcap32x24)
    # at its published widths: MGM 32 / CAP 24 over two embedding tokens a
    # row, 19 features two a group (the last group half filled)
    "petfinder": JMixerConfig(mixer_type="MGM+CAP", mgm_heads=32, cap_heads=24, in_dim=64),
}
# a mixer case's model and input options over the defaults of `test_forward_matches_jax`
SHAPES = {"petfinder": (dict(emsize=192, nhead=6, features_per_group=2), dict(F=19, n_img=2))}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_forward_matches_jax(mixer, path):
    cfg_kw, input_kw = SHAPES.get(mixer, ({}, {}))
    jcfg = JModelConfig(
        **(dict(emsize=32, nhead=4) | cfg_kw), nhid_factor=2, nlayers=2, n_out=5,
        mixer=MIXERS[mixer], compute_dtype="float32", model_seed=3,
    )
    tree = jax_param_tree(jcfg, seed=1)
    x, y, img = _inputs(2, image=mixer != "tabular", **input_kw)
    want = np.asarray(jforward(tree, jcfg, x, y, img, single_eval_pos=y.shape[1]))
    got = forward(
        tparams.params_from_jax(tree),
        to_port_config(jcfg, **PATHS[path]),
        torch.from_numpy(x),
        torch.from_numpy(y),
        None if img is None else torch.from_numpy(img),
        single_eval_pos=y.shape[1],
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


DISPATCH = {
    # 67 feature tokens, more than K1 takes: the sample-major layer with K2a +
    # K2b and K3
    "many_tokens": (dict(n_features=66), dict()),
    # no multiquery test block: the gate refuses the item kernels
    "no_multiquery": (dict(n_features=5), dict(multiquery_item_attention_for_test_set=False)),
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_kernel_path_dispatch_matches_jax(case, monkeypatch):
    """The kernel path's shapes and configurations that leave the item-major
    layer, against the JAX package's plain forward; the counts show which
    kernel wrappers the port's layers called."""
    from multimodalpfn_tpu_torch.models import transformer

    shape_kw, cfg_kw = DISPATCH[case]
    calls = {"item": 0, "mlp": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(transformer, "fused_item_sublayer", counted("item", transformer.fused_item_sublayer))
    monkeypatch.setattr(transformer, "fused_mlp_ln", counted("mlp", transformer.fused_mlp_ln))
    jcfg = JModelConfig(emsize=32, nhead=4, nhid_factor=2, nlayers=2, n_out=5,
                        mixer=MIXERS["tabular"], compute_dtype="float32", model_seed=3, **cfg_kw)
    tree = jax_param_tree(jcfg, seed=1)
    x, y, _ = _inputs(8, F=shape_kw["n_features"], image=False)
    want = np.asarray(jforward(tree, jcfg, x, y, None, single_eval_pos=y.shape[1]))
    got = forward(
        tparams.params_from_jax(tree),
        to_port_config(jcfg, **PATHS["kernels"]),
        torch.from_numpy(x),
        torch.from_numpy(y),
        single_eval_pos=y.shape[1],
    )
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    n_item = 0 if case == "no_multiquery" else jcfg.nlayers
    assert calls == {"item": n_item, "mlp": jcfg.nlayers}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", GOLDEN)
def test_forward_matches_reference_goldens(name, path):
    """The original PyTorch reference's logits (tests/golden/*.npz) through
    `convert_reference_state_dict`."""
    case = GoldenCase(name)
    cfg = to_port_config(case.cfg, **PATHS[path])
    params = tparams.convert_reference_state_dict(case.state_dict, cfg, model_seed=case.model_seed)
    x, y, image = case.jax_inputs()
    logits = forward(
        params,
        cfg,
        None if x is None else torch.from_numpy(np.asarray(x, np.float32)),
        torch.from_numpy(np.asarray(y, np.float32)),
        None if image is None else torch.from_numpy(np.asarray(image, np.float32)),
        single_eval_pos=case.sep,
    )
    got = logits.numpy()[0]
    assert got.shape == case.logits.shape
    np.testing.assert_allclose(got, case.logits, **TOL)


def test_params_from_jax_round_trip():
    jcfg = JModelConfig(emsize=32, nhead=4, nhid_factor=2, nlayers=2, n_out=5,
                        mixer=MIXERS["mgm_cap"])
    tree = jax_param_tree(jcfg, seed=4)
    back = tparams.params_to_numpy(tparams.params_from_jax(tree))
    flat_a, flat_b = tparams.flatten_params(tree), tparams.flatten_params(back)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)


@pytest.mark.parametrize("mixer_type", ["MGM+CAP", "MoE", "none"])
def test_convert_reference_state_dict_round_trip(mixer_type):
    cfg = ModelConfig(emsize=32, nhead=4, nhid_factor=2, nlayers=2, n_out=5,
                      mixer=MixerConfig(mixer_type=mixer_type, mgm_heads=2, cap_heads=4, in_dim=64))
    params = tparams.init_params(torch.Generator().manual_seed(0), cfg)
    sd = tparams.export_reference_state_dict(params, cfg)
    back = tparams.convert_reference_state_dict(sd, cfg)
    flat_a, flat_b = tparams.flatten_params(params), tparams.flatten_params(back)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert torch.equal(flat_a[k], flat_b[k]), k


def test_converters_agree_across_packages():
    """A reference state dict exported by the JAX package converts to the same
    tree in both packages."""
    jcfg = JModelConfig(emsize=32, nhead=4, nhid_factor=2, nlayers=2, n_out=5,
                        mixer=MIXERS["mgm_cap"])
    tree = jax_param_tree(jcfg, seed=5)
    sd = jparams.export_torch_state_dict(tree, jcfg)
    got = tparams.flatten_params(
        tparams.params_to_numpy(tparams.convert_reference_state_dict(sd, to_port_config(jcfg)))
    )
    want = tparams.flatten_params(tree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_npz_round_trip(tmp_path):
    jcfg = JModelConfig(emsize=32, nhead=4, nhid_factor=2, nlayers=2, n_out=5,
                        mixer=MIXERS["mgm_only"], model_seed=7)
    tree = jax_param_tree(jcfg, seed=6)
    save_npz(tmp_path / "m.npz", tree, jcfg)
    loaded = load_npz(tmp_path / "m.npz")
    assert loaded.config == to_port_config(jcfg)
    flat = tparams.flatten_params(tparams.params_to_numpy(loaded.params))
    for k, v in tparams.flatten_params(tree).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


@pytest.mark.parametrize("seed", [0, 5])
def test_subspace_noise_matches_jax_package(seed):
    """The noise table is the torch-CPU draw in both packages, including the
    reference's unseeded generator for seed 0."""
    want = jparams.get_subspace_noise(seed, 9, 8)
    got = tparams.get_subspace_noise(seed, 9, 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("seed", [0, 5])
def test_subspace_noise_is_one_tensor_per_device(seed, device):
    """The CPU draw's values (seed 0 from the unseeded generator), one kept
    tensor for each (seed, tokens, width, device)."""
    gen = torch.Generator()
    if seed:
        gen.manual_seed(seed)
    draw = torch.randn((9, 8), generator=gen)
    got = tparams.get_subspace_noise(seed, 9, 8, device=device)
    assert got.device.type == device and got.shape == draw.shape
    if device == "cpu":
        assert torch.equal(got, draw)
    assert tparams.get_subspace_noise(seed, 9, 8, device=torch.device(device)) is got
    assert tparams.get_subspace_noise(seed, 10, 8, device=device) is not got
