"""Bar distribution regression head (piecewise-uniform + half-normal tails).

The port of the JAX package's `models/bar_distribution.py`, which
re-implements the reference `mmpfn/models/mmpfn/model/bar_distribution.py`
(`BarDistribution:18-446`, `FullSupportBarDistribution:448-760`,
`get_bucket_limits:761-843`), on torch tensors. The methods are the JAX
package's, formula for formula (masked ``where`` rather than boolean
indexing), so the loss differentiates through plain autograd. Numpy borders
become float32, as they do in JAX with x64 off. ``plot`` imports matplotlib
when it is called, and nothing else of the port imports it.

The softmax's row sum and the cumsum over the bars add in the order the JAX
package's compiled programs add on the CPU (XLA sums a row in windows of 32,
and a prefix in blocks of 16): the quantile function divides the cumsum's
rounding by the probability of one bar, so another order moves a quantile of
5000 bars by about 1e-5 of the target's scale.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_SQRT2 = math.sqrt(2.0)
_HALF_NORMAL_ICDF_05 = _SQRT2 * 0.47693627620446987  # sqrt(2)*erfinv(0.5)


def _halfnormal_scale(range_max, p: float = 0.5):
    """HalfNormal scale s.t. p of the mass lies before range_max
    (reference `bar_distribution.py:477-485`)."""
    return range_max / _HALF_NORMAL_ICDF_05


def _halfnormal_logpdf(x, scale):
    return 0.5 * math.log(2.0 / math.pi) - torch.log(scale) - 0.5 * (x / scale) ** 2


def _halfnormal_cdf(x, scale):
    return torch.erf(x / (scale * _SQRT2))


def _halfnormal_mean(scale):
    return scale * math.sqrt(2.0 / math.pi)


def _halfnormal_var(scale):
    return scale**2 * (1.0 - 2.0 / math.pi)


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last (short) axis, added one at a time
    (on contiguous slices: the short axis is moved to the front)."""
    xt = x.movedim(-1, 0).contiguous()
    out = torch.empty_like(xt)
    out[0] = xt[0]
    for k in range(1, xt.shape[0]):
        torch.add(out[k - 1], xt[k], out=out[k])
    return out.movedim(0, -1)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """The last prefix sum of `_seq_cumsum`: the short last axis added one
    element at a time."""
    xt = x.movedim(-1, 0).contiguous()
    acc = xt[0].clone()
    for k in range(1, xt.shape[0]):
        acc += xt[k]
    return acc


def _cumsum(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Prefix sums along the last axis in XLA's order: each block of 16 summed
    in turn, the blocks' totals prefix-summed the same way, and each block's
    exclusive prefix added to its sums."""
    n = x.shape[-1]
    if n <= block:
        return _seq_cumsum(x)
    rows = -(-n // block)
    w = _seq_cumsum(F.pad(x, (0, rows * block - n)).reshape(*x.shape[:-1], rows, block))
    totals = _cumsum(w[..., -1], block)
    before = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]], dim=-1)
    return (w + before[..., None]).reshape(*x.shape[:-1], rows * block)[..., :n].contiguous()


def _row_sum(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """The sum along the last axis in XLA's order: zero-padded evenly to a
    multiple of 32, each window of 32 summed in turn, and the windows' sums
    reduced the same way until at most 32 remain, which are summed in turn."""
    while x.shape[-1] > window:
        n = x.shape[-1]
        pad = -(-n // window) * window - n
        x = _seq_sum(F.pad(x, (pad // 2, pad - pad // 2)).reshape(*x.shape[:-1], -1, window))
    return _seq_sum(x)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``: exp(x - max), divided by its row sum."""
    e = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    return e / _row_sum(e)[..., None]


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(values, idx, axis=-1)`` with ``values`` broadcast to
    ``idx``'s leading dims."""
    values = values.expand(*idx.shape[:-1], values.shape[-1])
    return torch.gather(values, -1, idx)


class FullSupportBarDistribution:
    """Distribution over ``num_bars`` buckets with half-normal tail buckets."""

    def __init__(self, borders):
        if not isinstance(borders, torch.Tensor):
            borders = torch.as_tensor(np.asarray(borders, dtype=np.float32))
        self.borders = borders  # (num_bars + 1,) sorted

    # -- basic geometry ------------------------------------------------------
    @property
    def bucket_widths(self) -> torch.Tensor:
        return self.borders[1:] - self.borders[:-1]

    @property
    def num_bars(self) -> int:
        return len(self.borders) - 1

    def map_to_bucket_idx(self, y: torch.Tensor) -> torch.Tensor:
        """reference `bar_distribution.py:156-162`."""
        idx = torch.searchsorted(self.borders, y.to(self.borders.dtype).contiguous()) - 1
        idx = torch.where(y == self.borders[0], 0, idx)
        return torch.where(y == self.borders[-1], self.num_bars - 1, idx)

    def _side_scales(self):
        w = self.bucket_widths
        return _halfnormal_scale(w[0]), _halfnormal_scale(w[-1])

    # -- loss -----------------------------------------------------------------
    def nll_loss(self, logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Negative log density; NaN targets contribute 0
        (reference `FullSupportBarDistribution.forward`, `bar_distribution.py:487-571`)."""
        ignore = torch.isnan(y)
        y = torch.where(ignore, self.borders[0], y)
        target = torch.clamp(self.map_to_bucket_idx(y), 0, self.num_bars - 1)
        scaled_log_probs = torch.log_softmax(logits, dim=-1) - torch.log(self.bucket_widths)
        lp = _take(scaled_log_probs, target[..., None])[..., 0]
        s0, s1 = self._side_scales()
        w = self.bucket_widths
        left = _halfnormal_logpdf(torch.clamp(self.borders[1] - y, min=1e-8), s0) + torch.log(w[0])
        right = _halfnormal_logpdf(torch.clamp(y - self.borders[-2], min=1e-8), s1) + torch.log(w[-1])
        lp = torch.where(target == 0, lp + left, lp)
        lp = torch.where(target == self.num_bars - 1, lp + right, lp)
        return torch.where(ignore, 0.0, -lp)

    __call__ = nll_loss

    def compute_scaled_log_probs(self, logits: torch.Tensor) -> torch.Tensor:
        """log p(y) of the piecewise-uniform density
        (reference `bar_distribution.py:173-176`)."""
        return torch.log_softmax(logits, dim=-1) - torch.log(self.bucket_widths)

    def full_ce(self, logits: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
        """Cross-entropy against a full bucket distribution
        (reference `bar_distribution.py:178-179`)."""
        return -(probs * torch.log_softmax(logits, dim=-1)).sum(dim=-1)

    def mean_loss(self, logits: torch.Tensor, mean_prediction_logits: torch.Tensor) -> torch.Tensor:
        """NLL of each batch element's mean prediction under separate
        mean-prediction logits (reference `bar_distribution.py:220-241`).

        logits: ``(T, B, num_bars)``; mean_prediction_logits: ``(B, num_bars)``.
        Returns ``(1, B)``.
        """
        assert logits.ndim == 3, logits.ndim
        assert mean_prediction_logits.ndim == 2, mean_prediction_logits.ndim
        scaled_mean_log_probs = self.compute_scaled_log_probs(mean_prediction_logits)
        means = self.mean(logits).detach()  # (T, B)
        target_mean = torch.clamp(self.map_to_bucket_idx(means), 0, self.num_bars - 1)
        picked = torch.gather(scaled_mean_log_probs, 1, target_mean.T)  # (B, T)
        return -picked.mean(dim=1)[None]

    def cdf_temporary(self, logits: torch.Tensor) -> torch.Tensor:
        """The reference's helper (`bar_distribution.py:248-255`):
        ``-cumsum(softmax(logits)).sum(-1)``, which reduces the bucket axis
        away (not a per-bucket CDF; `cdf` is that)."""
        probs = _softmax(logits)
        return -_cumsum(probs).sum(dim=-1)

    # -- moments / point estimates --------------------------------------------
    def plot(self, logits: torch.Tensor, ax=None, zoom_to_quantile=None, **kwargs):
        """Bar plot of one distribution (reference `bar_distribution.py:411-445`,
        JAX package `models/bar_distribution.py:151`): bar heights are the
        densities ``softmax(logits) / width``; ``zoom_to_quantile`` limits
        the x axis to that central quantile and plots the bars inside it.
        Needs matplotlib, imported here: plotting is optional."""
        import matplotlib.pyplot as plt

        logits = torch.as_tensor(logits).squeeze()
        if logits.ndim != 1:
            raise ValueError("logits should be 1d, at least after squeezing.")
        if ax is None:
            ax = plt.gca()
        borders = self.borders.cpu().numpy()
        widths = self.bucket_widths.cpu().numpy()
        if zoom_to_quantile is not None:
            bounds = self.quantile(logits, zoom_to_quantile).cpu().numpy()
            lower_bound, upper_bound = float(bounds[..., 0].min()), float(bounds[..., 1].max())
            ax.set_xlim(lower_bound, upper_bound)
            border_mask = (borders[:-1] >= lower_bound) & (borders[1:] <= upper_bound)
        else:
            border_mask = slice(None)
        p = (_softmax(logits) / self.bucket_widths).cpu().numpy()
        ax.bar(borders[:-1][border_mask], p[border_mask], widths[border_mask], **kwargs)
        return ax

    def _bucket_means(self) -> torch.Tensor:
        return self.borders[:-1] + self.bucket_widths / 2

    def mean(self, logits: torch.Tensor) -> torch.Tensor:
        """reference `bar_distribution.py:588-598`: tail buckets use the
        half-normal means."""
        bucket_means = self._bucket_means().clone()
        s0, s1 = self._side_scales()
        bucket_means[0] = -_halfnormal_mean(s0) + self.borders[1]
        bucket_means[-1] = _halfnormal_mean(s1) + self.borders[-2]
        p = _softmax(logits)
        return p @ bucket_means.to(logits.dtype)

    def mean_of_square(self, logits: torch.Tensor) -> torch.Tensor:
        """reference `bar_distribution.py:600-627` (its tail formula,
        including the variance-in-mean quirk on the right tail)."""
        lb, rb = self.borders[:-1], self.borders[1:]
        ms = (lb**2 + rb**2 + lb * rb) / 3.0
        s0, s1 = self._side_scales()
        ms[0] = _halfnormal_var(s0) + (-_halfnormal_mean(s0) + self.borders[1]) ** 2
        ms[-1] = _halfnormal_var(s1) + (_halfnormal_var(s1) + self.borders[-2]) ** 2
        p = _softmax(logits)
        return p @ ms.to(logits.dtype)

    def variance(self, logits: torch.Tensor) -> torch.Tensor:
        return self.mean_of_square(logits) - self.mean(logits) ** 2

    def mode(self, logits: torch.Tensor) -> torch.Tensor:
        density = _softmax(logits) / self.bucket_widths
        return self._bucket_means()[torch.argmax(density, dim=-1)]

    def median(self, logits: torch.Tensor) -> torch.Tensor:
        return self.icdf(logits, 0.5)

    # -- cdf / quantiles --------------------------------------------------------
    def cdf(self, logits: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        """P(Y <= ys) under the bucket distribution (reference
        `bar_distribution.py:59-97`). 1-d ``ys`` are evaluated for every
        leading batch element."""
        ys = torch.as_tensor(ys, dtype=self.borders.dtype, device=self.borders.device)
        if ys.ndim < logits.ndim and ys.ndim == 1:
            ys = ys.expand(*logits.shape[:-1], ys.shape[0])
        probs = _softmax(logits)
        buckets = torch.clamp(self.map_to_bucket_idx(ys), 0, self.num_bars - 1)
        prob_so_far = _cumsum(probs) - probs
        left = _take(prob_so_far, buckets)
        share = torch.clamp((ys - self.borders[buckets]) / self.bucket_widths[buckets], 0.0, 1.0)
        out = left + _take(probs, buckets) * share
        out = torch.where(ys <= self.borders[0], 0.0, out)
        out = torch.where(ys >= self.borders[-1], 1.0, out)
        return torch.clamp(out, 0.0, 1.0)

    def icdf(self, logits: torch.Tensor, left_prob) -> torch.Tensor:
        """Quantile function (reference `bar_distribution.py:256-283`).
        ``left_prob`` is a float or a tensor of the leading shape."""
        probs = _softmax(logits)
        cum = _cumsum(probs)
        lp = torch.as_tensor(left_prob, dtype=cum.dtype, device=cum.device)
        lp = lp.expand(cum.shape[:-1])[..., None].contiguous()
        idx = torch.clamp(torch.searchsorted(cum, lp), 0, cum.shape[-1] - 1)
        cum0 = torch.cat([torch.zeros_like(cum[..., :1]), cum], dim=-1)
        rest = lp[..., 0] - torch.gather(cum0, -1, idx)[..., 0]
        idx = idx[..., 0]
        lb = self.borders[idx]
        rb = self.borders[idx + 1]
        p_at = torch.gather(probs, -1, idx[..., None])[..., 0]
        return lb + (rb - lb) * rest / p_at

    def quantile(self, logits: torch.Tensor, center_prob: float = 0.682) -> torch.Tensor:
        side = (1.0 - center_prob) / 2
        return torch.stack([self.icdf(logits, side), self.icdf(logits, 1.0 - side)], dim=-1)

    def ucb(self, logits, best_f, rest_prob: float = (1 - 0.682) / 2, *, maximize=True):
        if maximize:
            rest_prob = 1 - rest_prob
        return self.icdf(logits, rest_prob)

    def pi(self, logits: torch.Tensor, best_f, *, maximize=True) -> torch.Tensor:
        """Probability of improvement with half-normal tails
        (reference `bar_distribution.py:629-676`)."""
        assert maximize
        best_f = torch.as_tensor(best_f, dtype=logits.dtype, device=logits.device)
        best_f = best_f.expand(logits.shape[:-1])
        p = _softmax(logits)
        factor = 1.0 - torch.clamp((best_f[..., None] - self.borders[:-1]) / self.bucket_widths, 0.0, 1.0)
        s0, s1 = self._side_scales()
        pos0 = -torch.clamp(best_f - self.borders[1], max=0.0)
        pos1 = torch.clamp(best_f - self.borders[-2], min=0.0)
        f0 = torch.where(pos0 > 0.0, _halfnormal_cdf(pos0, s0), 0.0)
        f1 = torch.where(pos1 > 0.0, 1.0 - _halfnormal_cdf(pos1, s1), 1.0)
        factor = torch.cat([f0[..., None], factor[..., 1:-1], f1[..., None]], dim=-1)
        return (p * factor).sum(-1)

    def _ei_for_halfnormal(self, scale, best_f):
        """EI under a half-normal tail (reference `bar_distribution.py:677-703`)."""
        u = (0.0 - best_f) / scale
        ucdf = 0.5 * (1.0 + torch.erf(u / _SQRT2))
        updf = torch.exp(-0.5 * u**2) / math.sqrt(2 * math.pi)
        return 2.0 * scale * (updf + u * ucdf)

    def ei(self, logits: torch.Tensor, best_f, *, maximize=True) -> torch.Tensor:
        """Expected improvement with half-normal tail buckets
        (reference `FullSupportBarDistribution.ei`, `bar_distribution.py:706-760`)."""
        assert maximize
        best_f = torch.as_tensor(best_f, dtype=logits.dtype, device=logits.device)
        best_f = best_f.expand(logits.shape[:-1])
        bf = best_f[..., None]
        lo, hi = self.borders[:-1], self.borders[1:]
        clamped = torch.minimum(torch.maximum(bf, lo), hi)
        contrib = ((hi**2 - clamped**2) / 2 - bf * (hi - clamped)) / self.bucket_widths
        s0, s1 = self._side_scales()
        pos0 = -torch.clamp(best_f - self.borders[1], max=0.0)
        pos1 = torch.clamp(best_f - self.borders[-2], min=0.0)
        last = self._ei_for_halfnormal(s1, pos1)
        first = self._ei_for_halfnormal(s0, torch.zeros_like(pos0)) - self._ei_for_halfnormal(s0, pos0)
        contrib = torch.cat([first[..., None], contrib[..., 1:-1], last[..., None]], dim=-1)
        p = _softmax(logits)
        return torch.einsum("...b,...b->...", p, contrib)

    def pdf(self, logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.exp(-self.nll_loss(logits, y))

    def sample(self, logits: torch.Tensor, generator: torch.Generator, t: float = 1.0) -> torch.Tensor:
        """One draw per leading element: the quantile function at a uniform
        level drawn from ``generator`` (a generator on ``logits``' device)."""
        ps = torch.rand(logits.shape[:-1], generator=generator, device=logits.device,
                        dtype=logits.dtype)
        return self.icdf(logits / t, ps)

    # -- border translation (ensembling) ---------------------------------------
    def get_probs_for_different_borders(self, logits: torch.Tensor, new_borders) -> torch.Tensor:
        """Re-express this distribution over different borders
        (reference `bar_distribution.py:99-121`)."""
        new_borders = torch.as_tensor(new_borders, dtype=self.borders.dtype, device=self.borders.device)
        if len(self.borders) == len(new_borders) and bool(torch.all(self.borders == new_borders)):
            return _softmax(logits)
        pl = self.cdf(logits, new_borders)
        pl = torch.cat([torch.zeros_like(pl[..., :1]), pl[..., 1:-1], torch.ones_like(pl[..., :1])], dim=-1)
        return torch.clamp(pl[..., 1:] - pl[..., :-1], min=0.0)

    def average_bar_distributions_into_this(self, bar_dists, logits_list, *, average_logits: bool = False):
        """reference `bar_distribution.py:123-148`."""
        probs = torch.stack(
            [bd.get_probs_for_different_borders(lo, self.borders) for bd, lo in zip(bar_dists, logits_list)],
            dim=0,
        )
        if average_logits:
            probs = _softmax(torch.log(probs).mean(dim=0))
        else:
            probs = probs.mean(dim=0)
        return torch.log(probs)


def get_bucket_limits(
    num_outputs: int,
    full_range: tuple | None = None,
    ys: np.ndarray | None = None,
    *,
    widen_bucket_limits_factor: float | None = None,
) -> np.ndarray:
    """Data-driven bucket borders (reference `bar_distribution.py:761-843`)."""
    assert (ys is None) != (full_range is None)
    if ys is not None:
        ys = np.asarray(ys).flatten()
        ys = ys[~np.isnan(ys)]
        assert len(ys) > num_outputs
        if len(ys) % num_outputs:
            ys = ys[: -(len(ys) % num_outputs)]
        per = len(ys) // num_outputs
        if full_range is None:
            full_range = (float(ys.min()), float(ys.max()))
        else:
            assert full_range[0] <= ys.min() and full_range[1] >= ys.max()
        ys_sorted = np.sort(ys)
        limits = (ys_sorted[per - 1 :: per][:-1] + ys_sorted[per::per]) / 2
        limits = np.concatenate([[full_range[0]], limits, [full_range[1]]])
        if widen_bucket_limits_factor is not None:
            limits = limits * widen_bucket_limits_factor
    else:
        width = (full_range[1] - full_range[0]) / num_outputs
        limits = np.concatenate([full_range[0] + np.arange(num_outputs) * width, [full_range[1]]])
    assert len(limits) - 1 == num_outputs
    return limits.astype(np.float32)
