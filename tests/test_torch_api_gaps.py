"""Two parts of already-ported modules against the JAX package's, in float32
on the CPU: ``forward(..., return_embeddings=True)`` on both item layouts
(`models/transformer.py`), and ``FullSupportBarDistribution.plot``
(`models/bar_distribution.py`), whose test skips without matplotlib.
"""

import jax
import numpy as np
import pytest
import torch

from multimodalpfn_tpu.models.bar_distribution import FullSupportBarDistribution as JBar
from multimodalpfn_tpu.models.config import MixerConfig as JMixerConfig
from multimodalpfn_tpu.models.config import ModelConfig as JModelConfig
from multimodalpfn_tpu.models.transformer import forward as jforward
from multimodalpfn_tpu_torch.models import params as tparams
from multimodalpfn_tpu_torch.models.bar_distribution import FullSupportBarDistribution
from multimodalpfn_tpu_torch.models.transformer import forward
from tests.test_torch_forward import PATHS, TOL, _inputs, jax_param_tree, to_port_config


@pytest.mark.parametrize("path", sorted(PATHS))  # plain: sample-major; kernels: item-major
def test_return_embeddings_matches_jax(path):
    jcfg = JModelConfig(
        emsize=32, nhead=4, nhid_factor=2, nlayers=2, n_out=5, compute_dtype="float32", model_seed=3,
        mixer=JMixerConfig(mixer_type="MGM+CAP", mgm_heads=2, cap_heads=4, in_dim=64),
    )
    tree = jax_param_tree(jcfg, seed=1)
    x, y, img = _inputs(2)
    sep = y.shape[1]
    want = jforward(tree, jcfg, x, y, img, single_eval_pos=sep, return_embeddings=True)
    got = forward(tparams.params_from_jax(tree), to_port_config(jcfg, **PATHS[path]),
                  torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(img),
                  single_eval_pos=sep, return_embeddings=True)
    assert set(got) == set(want) == {"standard", "train_embeddings", "test_embeddings"}
    for key, shape in (("standard", (2, 15, 5)), ("train_embeddings", (2, sep, 32)),
                       ("test_embeddings", (2, 15, 32))):
        assert got[key].shape == shape and got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL, err_msg=key)
    plain = forward(tparams.params_from_jax(tree), to_port_config(jcfg, **PATHS[path]),
                    torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(img),
                    single_eval_pos=sep)
    torch.testing.assert_close(plain, got["standard"], rtol=0, atol=0)


@pytest.mark.parametrize("zoom", [None, 0.6])
def test_bar_plot_matches_jax(zoom):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    borders = np.linspace(-3.0, 3.0, 41).astype(np.float32)
    logits = np.random.default_rng(0).normal(size=(1, 40)).astype(np.float32)
    bars = []
    for dist, lg in ((FullSupportBarDistribution(borders), torch.from_numpy(logits)),
                     (JBar(jax.numpy.asarray(borders)), jax.numpy.asarray(logits))):
        fig, ax = plt.subplots()
        assert dist.plot(lg, ax=ax, zoom_to_quantile=zoom, color="C1") is ax
        bars.append((np.array([(p.get_x(), p.get_width(), p.get_height()) for p in ax.patches]),
                     ax.get_xlim()))
        plt.close(fig)
    (got, got_lim), (want, want_lim) = bars
    assert len(got) == len(want) == (40 if zoom is None else len(want)) and len(got) > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_lim, want_lim, rtol=1e-6)
    with pytest.raises(ValueError, match="1d"):
        FullSupportBarDistribution(borders).plot(torch.zeros(2, 40))
