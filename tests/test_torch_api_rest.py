"""The last public functions of the JAX package, in the port, against their
JAX counterparts on the same seeded inputs (float32 on the CPU):

* `models/encoders.py`: ``frequency_features``,
  ``categorical_embedding_encoder`` (NaN, ±inf, negative, fractional and
  out-of-range codes) and ``style_encoder``, within 1e-6;
* `estimator/base.py`: ``default_model_config`` equal to the JAX dict for
  the classifier and the regressor, and a copy;
* `ops/attention.py`: ``self_attention`` with and without ``key_mask``,
  within 1e-6, and equal to ``mha(x, x, ...)``;
* `train/data.py`: ``EpisodeSampler.sample_indices`` and ``sample``, the
  same episodes as the JAX sampler's at the same seed, and the rows of one
  are the indices of the other;
* `models/bar_distribution.py`: ``plot`` of a 1000-bar distribution on the
  Agg backend (the 40-bar case is `tests/test_torch_api_gaps.py`'s), the
  same bars and x-limits as the JAX ``plot``; and no port module imports
  matplotlib when it is imported (only ``plot`` does, when it is called).
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalpfn_tpu.estimator import base as jbase
from multimodalpfn_tpu.models import encoders as jenc
from multimodalpfn_tpu.ops import attention as jattn
from multimodalpfn_tpu.train import data as jdata
from multimodalpfn_tpu_torch.estimator import base
from multimodalpfn_tpu_torch.models import encoders as enc
from multimodalpfn_tpu_torch.models.loading import DEFAULT_CLASSIFIER_CONFIG, DEFAULT_REGRESSOR_CONFIG
from multimodalpfn_tpu_torch.ops import attention
from multimodalpfn_tpu_torch.train import data
from tests.test_torch_utils import few_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=0, atol=1e-6)


def _f32(rng, *shape) -> np.ndarray:
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("args", [(4,), (3, 3.0, 10.0), (1,)], ids=["default", "base3", "one"])
def test_frequency_features_match_jax(args):
    x = _f32(np.random.default_rng(0), 2, 7, 5) * 3
    got = enc.frequency_features(torch.from_numpy(x), *args)
    want = np.asarray(jenc.frequency_features(jnp.asarray(x), *args))
    assert got.shape == want.shape == (2, 7, 5 * (1 + 2 * args[0])) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_categorical_embedding_encoder_matches_jax():
    rng = np.random.default_rng(1)
    b, s, f, e, num_embs = 2, 9, 4, 8, 6
    x = rng.integers(-1, num_embs + 2, size=(b, s, f)).astype(np.float32)
    x[0, :7, 1] = [np.nan, np.inf, -np.inf, 2.7, -0.5, 1e10, num_embs - 1.5]
    x[1, 3, 2] = np.nan
    is_cat = np.array([[True, True, False, True], [False, True, True, False]])
    params = {"embedding": _f32(rng, num_embs, e)}
    cont = _f32(rng, b, s, f, e)
    got = enc.categorical_embedding_encoder({"embedding": torch.from_numpy(params["embedding"])},
                                            torch.from_numpy(x), torch.from_numpy(is_cat), torch.from_numpy(cont))
    want = np.asarray(jenc.categorical_embedding_encoder({"embedding": jnp.asarray(params["embedding"])},
                                                         jnp.asarray(x), jnp.asarray(is_cat), jnp.asarray(cont)))
    assert got.shape == want.shape == (b, s, f, e)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # NaN and ±inf take the last slot, continuous features keep their embeddings
    np.testing.assert_array_equal(got[0, :3, 1].numpy(), np.repeat(params["embedding"][-1:], 3, axis=0))
    np.testing.assert_array_equal(got[0, :, 2].numpy(), cont[0, :, 2])


def test_style_encoder_matches_jax():
    rng = np.random.default_rng(2)
    hp, w, b = _f32(rng, 3, 5), _f32(rng, 5, 16), _f32(rng, 16)
    got = enc.style_encoder({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(hp))
    want = np.asarray(jenc.style_encoder({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(hp)))
    assert got.shape == want.shape == (3, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("which", ["classifier", "regressor"])
def test_default_model_config_matches_jax(which):
    got = base.default_model_config(which)
    assert got == jbase.default_model_config(which)
    assert got == (DEFAULT_CLASSIFIER_CONFIG if which == "classifier" else DEFAULT_REGRESSOR_CONFIG)
    got["nlayers"] = 1  # a copy: the module's dict is untouched
    assert base.default_model_config(which)["nlayers"] == 12


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "key_mask"])
def test_self_attention_matches_jax(masked):
    rng = np.random.default_rng(3)
    x, w_qkv, w_out = _f32(rng, 3, 7, 16), _f32(rng, 3, 4, 4, 16) * 0.3, _f32(rng, 4, 4, 16) * 0.3
    mask = None
    if masked:  # (b, h, q, k): some keys of each batch row off, never all
        mask = np.ones((3, 1, 1, 7), bool)
        mask[0, ..., 5:] = False
        mask[2, ..., [0, 3]] = False
    got = attention.self_attention(torch.from_numpy(x), torch.from_numpy(w_qkv), torch.from_numpy(w_out),
                                   key_mask=None if mask is None else torch.from_numpy(mask))
    want = np.asarray(jattn.self_attention(jnp.asarray(x), jnp.asarray(w_qkv), jnp.asarray(w_out),
                                           key_mask=None if mask is None else jnp.asarray(mask)))
    assert got.shape == want.shape == (3, 7, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    same = attention.mha(torch.from_numpy(x), torch.from_numpy(x), torch.from_numpy(w_qkv),
                         torch.from_numpy(w_out), key_mask=None if mask is None else torch.from_numpy(mask))
    torch.testing.assert_close(got, same, rtol=0, atol=0)


@pytest.mark.filterwarnings("ignore:The least populated class")
@pytest.mark.parametrize("classification", [True, False], ids=["classification", "regression"])
def test_sample_indices_match_jax_and_sample(classification):
    rng = np.random.default_rng(4)
    n = 53
    X, im = _f32(rng, n, 4), _f32(rng, n, 1, 8)
    y = rng.integers(0, 3, size=n) if classification else rng.normal(size=n)
    kw = dict(X=X, image=im, y=y, is_classification=classification, seed=7)
    js, js_rows = jdata.EpisodeSampler(**kw), jdata.EpisodeSampler(**kw)
    ts, ts_rows = data.EpisodeSampler(**kw), data.EpisodeSampler(**kw)
    for _ in range(12):  # past a reshuffle of the fold stream (n_splits=10)
        idx, want = ts.sample_indices(2), js.sample_indices(2)
        assert set(idx) == {"train_idx", "test_idx"}
        assert idx["train_idx"].dtype == idx["test_idx"].dtype == np.int32
        assert idx["train_idx"].shape == (2, ts.train_size) and idx["test_idx"].shape == (2, ts.test_size)
        for key in idx:
            np.testing.assert_array_equal(idx[key], want[key])
        rows, want_rows = ts_rows.sample(2), js_rows.sample(2)
        assert list(rows) == list(want_rows)
        for key in rows:
            assert rows[key].dtype == np.float32
            np.testing.assert_array_equal(rows[key], want_rows[key], err_msg=key)
        np.testing.assert_array_equal(rows["x_train"], X[idx["train_idx"]])
        np.testing.assert_array_equal(rows["image_test"], im[idx["test_idx"]])
        np.testing.assert_array_equal(rows["y_test"], y[idx["test_idx"]].astype(np.float32))


@pytest.mark.parametrize("zoom", [None, 0.9])
def test_bar_plot_of_1000_bars_matches_jax(zoom):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from multimodalpfn_tpu.models.bar_distribution import FullSupportBarDistribution as JBar
    from multimodalpfn_tpu_torch.models.bar_distribution import FullSupportBarDistribution

    borders = np.linspace(-12.0, 12.0, 1001).astype(np.float32)
    logits = (-0.5 * (np.linspace(-6, 6, 1000) ** 2)
              + 0.1 * np.random.default_rng(5).normal(size=1000)).astype(np.float32)[None, None]
    bars = []
    for dist, lg in ((FullSupportBarDistribution(borders), torch.from_numpy(logits)),
                     (JBar(jnp.asarray(borders)), jnp.asarray(logits))):
        fig, ax = plt.subplots()
        assert dist.plot(lg, ax=ax, zoom_to_quantile=zoom, alpha=0.5) is ax
        bars.append((np.array([(p.get_x(), p.get_width(), p.get_height()) for p in ax.patches]),
                     ax.get_xlim(), {p.get_alpha() for p in ax.patches}))
        plt.close(fig)
    (got, got_lim, got_alpha), (want, want_lim, want_alpha) = bars
    assert len(got) == len(want) and (len(got) == 1000) == (zoom is None) and len(got) > 100
    assert got_alpha == want_alpha == {0.5}
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_lim, want_lim, rtol=1e-6)


def test_no_port_module_imports_matplotlib():
    """Importing every module of the port leaves matplotlib unimported, and
    the one import of it in the port's sources is inside
    ``FullSupportBarDistribution.plot``."""
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import multimodalpfn_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            if not m.name.rsplit(".", 1)[-1].startswith("_"):  # skip built .so files
                importlib.import_module(m.name)
        bad = [m for m in sys.modules if m.split(".")[0] in ("matplotlib", "jax", "multimodalpfn_tpu")]
        assert not bad, bad
        print("ok")
        """)], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    sites = []
    for path in sorted((REPO / "multimodalpfn_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        enclosing = {child: node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(name.split(".")[0] == "matplotlib" for name in names):
                fn = node
                while fn in enclosing and not isinstance(fn, ast.FunctionDef):
                    fn = enclosing[fn]
                sites.append((path.relative_to(REPO).as_posix(), getattr(fn, "name", "<module>")))
    assert sites == [("multimodalpfn_tpu_torch/models/bar_distribution.py", "plot")], sites
