"""The regressor's host pieces in the port against the JAX package's on the
same inputs: the bar distribution (`models/bar_distribution.py`, every
method but ``plot``, float32 on both sides), the border transforms and the
probability translation (`estimator/borders.py`, numpy on both sides, so
bit for bit), and the inverse transforms of `preprocess/numeric.py` against
scikit-learn 1.9.0's, bit for bit in float64.

The bar-distribution statistics are float32 reductions over the bars (a
softmax, a cumsum, a dot product) that the two packages sum in different
orders: they agree to 2e-6 relative (plus 2e-6 absolute near 0). The
quantile function (``icdf`` and what calls it) divides the cumsum's rounding
(about 2e-7: XLA sums in blocks of 16, torch's CPU cumsum in float64) by the
probability of the bar it lands in and scales it by that bar's width (up to
about 1 here): it agrees to 2e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.impute import SimpleImputer as SkSimpleImputer
from sklearn.pipeline import Pipeline as SkPipeline
from sklearn.preprocessing import FunctionTransformer as SkFunctionTransformer
from sklearn.preprocessing import MinMaxScaler as SkMinMaxScaler
from sklearn.preprocessing import PowerTransformer as SkPowerTransformer
from sklearn.preprocessing import StandardScaler as SkStandardScaler

from multimodalpfn_tpu.estimator import borders as jborders
from multimodalpfn_tpu.models import bar_distribution as jbd
from multimodalpfn_tpu.preprocess import safe_power as jsafe_power
from multimodalpfn_tpu.preprocess import steps as jsteps
from multimodalpfn_tpu_torch.estimator import borders
from multimodalpfn_tpu_torch.models import bar_distribution as bd
from multimodalpfn_tpu_torch.preprocess import numeric, safe_power, steps

STAT_TOL = dict(rtol=2e-6, atol=2e-6)
ICDF_TOL = dict(rtol=0, atol=2e-5)
ICDF_CASES = ("median", "icdf", "quantile", "ucb", "ucb_min")
N_BARS = 50


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    b = np.sort(rng.normal(size=N_BARS + 1) * 3).astype(np.float32)
    logits = (rng.normal(size=(4, 6, N_BARS)) * 2).astype(np.float32)
    y = (rng.normal(size=(4, 6)) * 4).astype(np.float32)
    y[0, :3] = b[[0, 7, -1]]  # targets on borders, the outer ones included
    return b, logits, y, rng


def _pair(b):
    return bd.FullSupportBarDistribution(b), jbd.FullSupportBarDistribution(jnp.asarray(b))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cases():
    """(name, port call, JAX call) on the same inputs."""
    b, logits, y, rng = _setup()
    other = np.sort(rng.normal(size=N_BARS + 1) * 2).astype(np.float32)
    ys_1d = np.sort(rng.normal(size=9) * 4).astype(np.float32)
    ys_full = (rng.normal(size=(4, 6, 5)) * 4).astype(np.float32)
    probs = rng.dirichlet(np.ones(N_BARS), size=(4, 6)).astype(np.float32)
    mean_logits = rng.normal(size=(6, N_BARS)).astype(np.float32)
    best_f = (rng.normal(size=(4, 6)) * 3).astype(np.float32)
    logits2 = (rng.normal(size=(4, 6, N_BARS)) * 2).astype(np.float32)
    L, Lj = _t(logits), jnp.asarray(logits)
    return [
        ("nll_loss", lambda d: d.nll_loss(L, _t(y)), lambda d: d.nll_loss(Lj, jnp.asarray(y))),
        ("compute_scaled_log_probs", lambda d: d.compute_scaled_log_probs(L),
         lambda d: d.compute_scaled_log_probs(Lj)),
        ("full_ce", lambda d: d.full_ce(L, _t(probs)), lambda d: d.full_ce(Lj, jnp.asarray(probs))),
        ("mean_loss", lambda d: d.mean_loss(L, _t(mean_logits)),
         lambda d: d.mean_loss(Lj, jnp.asarray(mean_logits))),
        ("cdf_temporary", lambda d: d.cdf_temporary(L), lambda d: d.cdf_temporary(Lj)),
        ("mean", lambda d: d.mean(L), lambda d: d.mean(Lj)),
        ("mean_of_square", lambda d: d.mean_of_square(L), lambda d: d.mean_of_square(Lj)),
        ("variance", lambda d: d.variance(L), lambda d: d.variance(Lj)),
        ("median", lambda d: d.median(L), lambda d: d.median(Lj)),
        ("cdf_1d", lambda d: d.cdf(L, _t(ys_1d)), lambda d: d.cdf(Lj, jnp.asarray(ys_1d))),
        ("cdf_full", lambda d: d.cdf(L, _t(ys_full)), lambda d: d.cdf(Lj, jnp.asarray(ys_full))),
        ("icdf", lambda d: d.icdf(L, 0.3), lambda d: d.icdf(Lj, 0.3)),
        ("quantile", lambda d: d.quantile(L, 0.5), lambda d: d.quantile(Lj, 0.5)),
        ("ucb", lambda d: d.ucb(L, 0.0), lambda d: d.ucb(Lj, 0.0)),
        ("ucb_min", lambda d: d.ucb(L, 0.0, maximize=False), lambda d: d.ucb(Lj, 0.0, maximize=False)),
        ("pi", lambda d: d.pi(L, _t(best_f)), lambda d: d.pi(Lj, jnp.asarray(best_f))),
        ("ei", lambda d: d.ei(L, _t(best_f)), lambda d: d.ei(Lj, jnp.asarray(best_f))),
        ("pdf", lambda d: d.pdf(L, _t(y)), lambda d: d.pdf(Lj, jnp.asarray(y))),
        ("probs_other_borders", lambda d: d.get_probs_for_different_borders(L, _t(other)),
         lambda d: d.get_probs_for_different_borders(Lj, jnp.asarray(other))),
        ("probs_same_borders", lambda d: d.get_probs_for_different_borders(L, _t(b)),
         lambda d: d.get_probs_for_different_borders(Lj, jnp.asarray(b))),
        # the log of averaged probabilities, compared as probabilities: the
        # log turns the rounding of a tiny bar's cdf difference into a large
        # relative error
        ("average_probs", lambda d: d.average_bar_distributions_into_this(
            [d, bd.FullSupportBarDistribution(other)], [L, _t(logits2)]).exp(),
         lambda d: jnp.exp(d.average_bar_distributions_into_this(
            [d, jbd.FullSupportBarDistribution(jnp.asarray(other))], [Lj, jnp.asarray(logits2)]))),
        ("average_logits", lambda d: d.average_bar_distributions_into_this(
            [d, bd.FullSupportBarDistribution(other)], [L, _t(logits2)], average_logits=True).exp(),
         lambda d: jnp.exp(d.average_bar_distributions_into_this(
            [d, jbd.FullSupportBarDistribution(jnp.asarray(other))], [Lj, jnp.asarray(logits2)],
            average_logits=True))),
    ]


_CASES = _cases()


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_method_matches_jax(case):
    _, port_call, jax_call = case
    b, *_ = _setup()
    d, jd = _pair(b)
    got = port_call(d)
    want = np.asarray(jax_call(jd))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **(ICDF_TOL if case[0] in ICDF_CASES else STAT_TOL))


def test_mode_and_bucket_index_match_jax():
    b, logits, y, _ = _setup()
    d, jd = _pair(b)
    np.testing.assert_array_equal(d.mode(_t(logits)).numpy(), np.asarray(jd.mode(jnp.asarray(logits))))
    np.testing.assert_array_equal(d.map_to_bucket_idx(_t(y)).numpy(),
                                  np.asarray(jd.map_to_bucket_idx(jnp.asarray(y))))
    assert d.num_bars == jd.num_bars == N_BARS
    np.testing.assert_array_equal(d.bucket_widths.numpy(), np.asarray(jd.bucket_widths))


def test_sample_is_icdf_at_uniform_levels():
    """``sample`` draws its levels from the given generator (JAX: a key, so
    the draws differ); at the same levels it is JAX's vmapped icdf."""
    b, logits, _, _ = _setup()
    d, jd = _pair(b)
    gen = torch.Generator().manual_seed(5)
    got = d.sample(_t(logits), gen, t=0.8)
    ps = torch.rand(logits.shape[:-1], generator=torch.Generator().manual_seed(5))
    flat = jnp.asarray(logits.reshape(-1, N_BARS)) / 0.8
    want = jax.vmap(lambda lo, p: jd.icdf(lo, p))(flat, jnp.asarray(ps.numpy().reshape(-1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(ps.shape), **ICDF_TOL)


def test_nll_nan_targets_and_gradient_match_jax():
    """A NaN target contributes 0 and still counts in the mean; the mean's
    gradient through autograd equals ``jax.grad``'s."""
    b, logits, y, _ = _setup()
    y[1, 2] = y[3, 0] = np.nan
    d, jd = _pair(b)
    L = _t(logits).requires_grad_(True)
    nll = d.nll_loss(L, _t(y))
    assert float(nll[1, 2].detach()) == 0.0 and float(nll[3, 0].detach()) == 0.0
    nll.mean().backward()
    want_loss, want_grad = jax.value_and_grad(lambda lo: jd.nll_loss(lo, jnp.asarray(y)).mean())(
        jnp.asarray(logits))
    np.testing.assert_allclose(float(nll.mean().detach()), float(want_loss), rtol=2e-6)
    assert torch.isfinite(L.grad).all()
    np.testing.assert_allclose(L.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("kind", ["range", "data", "data_widened"])
def test_get_bucket_limits_matches_jax(kind):
    ys = np.random.default_rng(1).normal(size=1003)
    ys[::50] = np.nan
    kw = {"range": dict(full_range=(-3.0, 5.0)), "data": dict(ys=ys),
          "data_widened": dict(ys=ys, widen_bucket_limits_factor=1.5)}[kind]
    got = bd.get_bucket_limits(100, **kw)
    want = jbd.get_bucket_limits(100, **kw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# --- borders.py: numpy on both sides, so bit for bit -------------------------

STD_BORDERS = np.linspace(-12, 12, 5001).astype(np.float32).astype(np.float64)


def _skewed_target(n=400, seed=0):
    """A standardized lognormal target (the regressor's y): its safepower
    transform's inverse pushes the upper borders past 1e3."""
    y = np.random.default_rng(seed).lognormal(sigma=1.0, size=n)
    return (y - y.mean()) / (y.std() + 1e-20)


def _fitted_target_transform(pkg_steps, name, y):
    t = pkg_steps.ReshapeFeatureDistributionsStep.make_transformer(name, num_examples=len(y),
                                                                   random_state=0)
    t.fit_transform(y.reshape(-1, 1))
    return t


@pytest.mark.parametrize("name", ["safepower", "safepower_box", "power", "descending"])
def test_transform_borders_one_bit_equal(name):
    """The whole member border transform on the package's own fitted target
    pipeline: the safepower case breaks borders (NaN / beyond ±1e3) and
    cancels their logits; "descending" stands for a transform whose
    inverse decreases (``FunctionTransformer(np.negative)`` both ways), which
    comes out descending and is flipped."""
    y = _skewed_target()
    if name == "descending":
        port_t = numeric.FunctionTransformer(np.negative, inverse_func=np.negative)
        jax_t = SkFunctionTransformer(np.negative, inverse_func=np.negative, check_inverse=False)
    else:
        port_t = _fitted_target_transform(steps, name, y)
        jax_t = _fitted_target_transform(jsteps, name, y)
    got = borders.transform_borders_one(STD_BORDERS, port_t, repair_nan_borders_after_transform=True)
    want = jborders.transform_borders_one(STD_BORDERS, jax_t, repair_nan_borders_after_transform=True)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    if want[0] is None:
        assert got[0] is None
    else:
        np.testing.assert_array_equal(got[0], want[0])
    if name == "safepower":
        assert want[0] is not None and want[0].sum() > 100
    if name == "descending":
        assert want[1] and bool(np.all(np.diff(got[2]) > 0))


def test_repair_and_cancel_bit_equal():
    rng = np.random.default_rng(3)
    b = np.sort(rng.normal(size=40))
    b[:4] = -np.inf
    b[-6:] = np.nan
    broken = ~np.isfinite(b)
    got = borders.cancel_nan_borders(borders=b, broken_mask=broken)
    want = jborders.cancel_nan_borders(borders=b, broken_mask=broken)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for arr in (np.r_[1.0, 1.0, 2.0, np.nan, np.nan], np.r_[-1.0, 0.0, 3.0, 3.0 + 1e-9]):
        a, ja = arr.copy(), arr.copy()
        borders.repair_borders(a)
        jborders.repair_borders(ja)
        np.testing.assert_array_equal(a, ja)


def test_translate_probs_bit_equal_and_not_identity():
    """Bit-equal to JAX's on random logits; translating a distribution onto
    its own borders is not the identity (the reference's ``_cdf``
    precedence quirk), so members without a target transform are translated
    too."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(7, 5000)) * 3
    frm = STD_BORDERS * 1.3 + 0.2
    got = borders.translate_probs_across_borders(logits, frm=frm, to=STD_BORDERS)
    want = jborders.translate_probs_across_borders(logits, frm=frm, to=STD_BORDERS)
    np.testing.assert_array_equal(got, want)
    same = borders.translate_probs_across_borders(logits, frm=STD_BORDERS, to=STD_BORDERS)
    softmax = np.exp(logits - logits.max(-1, keepdims=True))
    softmax /= softmax.sum(-1, keepdims=True)
    assert np.abs(same - softmax).max() > 1e-4


# --- inverse transforms against scikit-learn 1.9.0, bit for bit --------------


def _col(n=300, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(size=n), rng.lognormal(size=n), np.full(n, 2.5),
                     -rng.exponential(size=n) * 3], axis=1)


def test_standard_scaler_inverse_bit_equal():
    X = _col()
    Z = np.random.default_rng(1).normal(size=(50, 4)) * 3
    Z[3, 1] = np.nan
    got = numeric.StandardScaler().fit(X).inverse_transform(Z)
    want = SkStandardScaler().fit(X).inverse_transform(Z)
    np.testing.assert_array_equal(got, want)  # the constant column keeps scale 1


def test_minmax_scaler_inverse_bit_equal():
    X = _col()
    Z = np.random.default_rng(2).uniform(0.0, 1.2, size=(50, 4))
    got = numeric.MinMaxScaler().fit(X).inverse_transform(Z)
    want = SkMinMaxScaler(feature_range=(0.1, 1), clip=True).fit(X).inverse_transform(Z)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lmbda", [0.0, 2.0, 0.37, -1.3, 2.9, np.nan],
                         ids=["zero", "two", "mid", "negative", "above_two", "nan"])
def test_yeo_johnson_inverse_bit_equal(lmbda):
    """Each of the four branches, and a NaN λ (what a failed λ fit leaves in
    a `SafePowerTransformer`)."""
    Z = np.random.default_rng(3).normal(size=(200, 1)) * 2
    Z[5] = 0.0
    port = numeric.PowerTransformer()
    sk = SkPowerTransformer(standardize=False).fit(np.random.default_rng(0).normal(size=(30, 1)))
    port.lambdas_ = sk.lambdas_ = np.array([lmbda])
    with np.errstate(all="ignore"):
        np.testing.assert_array_equal(port.inverse_transform(Z), sk.inverse_transform(Z))


def test_box_cox_inverse_bit_equal():
    X = np.random.default_rng(4).lognormal(size=(300, 2))
    Z = np.random.default_rng(5).normal(size=(60, 2))
    got = numeric.PowerTransformer(method="box-cox").fit(X).inverse_transform(Z)
    want = SkPowerTransformer(method="box-cox", standardize=False).fit(X).inverse_transform(Z)
    np.testing.assert_array_equal(got, want)


def test_function_transformer_and_pipeline_inverse_bit_equal():
    X = np.abs(_col()) + 0.5
    Z = np.random.default_rng(6).normal(size=(40, 4))
    port = numeric.Pipeline([("log", numeric.FunctionTransformer(np.log)),
                             ("exp", numeric.FunctionTransformer(np.exp, inverse_func=np.log)),
                             ("std", numeric.StandardScaler())])
    sk = SkPipeline([("log", SkFunctionTransformer(np.log, check_inverse=False)),
                     ("exp", SkFunctionTransformer(np.exp, inverse_func=np.log, check_inverse=False)),
                     ("std", SkStandardScaler())])
    port.fit(X)
    sk.fit(X)
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(port.inverse_transform(Z), sk.inverse_transform(Z))


def test_imputer_inverse_is_identity():
    X = _col()
    X[::7, 0] = np.nan
    imp = numeric.SimpleImputer().fit(X)
    Z = np.random.default_rng(7).normal(size=(5, 4))
    assert imp.inverse_transform(Z) is Z
    ref = jsafe_power._IdentityInverseImputer(strategy="mean", keep_empty_features=True).fit(X)
    assert isinstance(ref, SkSimpleImputer) and ref.inverse_transform(Z) is Z


@pytest.mark.parametrize("name", ["safepower", "power", "safepower_box", "power_box"])
def test_target_pipeline_inverse_bit_equal(name):
    """The regressor's target pipelines, fitted by ``fit_transform`` as
    `fit_preprocessing_one` fits them, then inverted: equal to the JAX
    package's scikit-learn pipelines bit for bit, overflows included. A
    `SafePowerTransformer` fitted this way sets no ``revert_indices_``, and
    its inverse applies λ to every column."""
    y = _skewed_target(seed=2)
    port_t = _fitted_target_transform(steps, name, y)
    jax_t = _fitted_target_transform(jsteps, name, y)
    if name == "safepower":
        assert port_t.steps[0][1].revert_indices_ is None
        assert jax_t.steps[0][1].revert_indices_ is None
    Z = STD_BORDERS.reshape(-1, 1)
    with np.errstate(all="ignore"):
        got = port_t.inverse_transform(Z)
        want = jax_t.inverse_transform(Z)
    np.testing.assert_array_equal(got, want)


def test_safe_power_nan_lambda_inverse_matches_jax():
    """A column whose λ fit failed (NaN): both packages' inverse give NaN for
    the non-negative values and ``1 - exp(-x)`` for the negative ones."""
    port_t = safe_power.SafePowerTransformer()
    jax_t = jsafe_power.SafePowerTransformer(standardize=False)
    X = np.random.default_rng(8).normal(size=(40, 1))
    port_t.fit_transform(X)
    jax_t.fit_transform(X)
    port_t.lambdas_ = np.array([np.nan])
    jax_t.lambdas_ = np.array([np.nan])
    Z = np.linspace(-2, 2, 9).reshape(-1, 1)
    with np.errstate(all="ignore"):
        got = port_t.inverse_transform(Z)
        want = jax_t.inverse_transform(Z)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[Z >= 0]).all()
    np.testing.assert_array_equal(got[Z < 0], 1 - np.exp(-Z[Z < 0]))


@pytest.mark.parametrize("n", [5000, 1001, 50, 33, 17, 16, 3])
def test_sums_follow_xla_order(n):
    """The bar distribution's row sum and cumsum add in the order XLA's CPU
    programs do (`_row_sum`, `_cumsum`): bit-equal to ``jnp.sum`` and
    ``jnp.cumsum`` over the last axis."""
    x = np.random.default_rng(n).exponential(size=(6, n)).astype(np.float32)
    np.testing.assert_array_equal(bd._row_sum(_t(x)).numpy(), np.asarray(jnp.sum(jnp.asarray(x), -1)))
    np.testing.assert_array_equal(bd._cumsum(_t(x)).numpy(), np.asarray(jnp.cumsum(jnp.asarray(x), -1)))
