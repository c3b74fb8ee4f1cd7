"""The port's scores, weights, losses and climatology against the JAX
package, in fp32 on the CPU, with SST-like NaNs in the truth."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladcast_torch.metrics import climatology as t_clim
from ladcast_torch.metrics import losses as t_losses
from ladcast_torch.metrics import scores as t_scores
from ladcast_torch.metrics import weights as t_weights
from ladcast_tpu.metrics import climatology as j_clim
from ladcast_tpu.metrics import losses as j_losses
from ladcast_tpu.metrics import scores as j_scores
from ladcast_tpu.metrics import weights as j_weights

REL = 1e-6


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    scale = max(np.abs(want[ok]).max(), 1e-30)
    assert np.abs(got[ok] - want[ok]).max() <= rel * scale, (
        np.abs(got[ok] - want[ok]).max() / scale)


def _inputs(seed=0, E=6, C=3, H=12, W=16):
    """Members (C, E, H, W), truth and climate (C, H, W) with NaNs over a
    'land' block of the last channel, and cos-lat weights (H, 1)."""
    rng = np.random.RandomState(seed)
    fc = rng.randn(C, E, H, W).astype(np.float32)
    tr = rng.randn(C, H, W).astype(np.float32)
    cl = (0.3 * rng.randn(C, H, W)).astype(np.float32)
    tr[-1, 2:6, 3:9] = np.nan
    lw = t_weights.cos_lat_weights(np.linspace(-80, 80, H)).astype(np.float32)
    return fc, tr, cl, lw.reshape(-1, 1)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("fn", ["crps", "skill", "spread"])
@pytest.mark.parametrize("E", [1, 2, 7])
def test_crps_parts_match_jax(fn, E):
    fc, tr, _, _ = _inputs(E=E)
    if fn == "crps":
        got = t_scores.crps(T(fc), T(tr)[:, None], 1)
        want = j_scores.crps(jnp.asarray(fc), jnp.asarray(tr)[:, None], 1)
    elif fn == "skill":
        got = t_scores.pointwise_crps_skill(T(fc), T(tr)[:, None], 1)
        want = j_scores.pointwise_crps_skill(jnp.asarray(fc), jnp.asarray(tr)[:, None], 1)
    else:
        got = t_scores.pointwise_crps_spread(T(fc), 1)
        want = j_scores.pointwise_crps_spread(jnp.asarray(fc), 1)
    _close(got.numpy(), want)


@pytest.mark.parametrize("nan_safe", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_acc_and_mse_match_jax(nan_safe, weighted):
    fc, tr, cl, lw = _inputs(1)
    em = fc.mean(1)
    w_t, w_j = (T(lw), jnp.asarray(lw)) if weighted else (None, None)
    _close(t_scores.acc(T(em), T(tr), T(cl), w_t, nan_safe).numpy(),
           j_scores.acc(jnp.asarray(em), jnp.asarray(tr), jnp.asarray(cl), w_j,
                        nan_safe))
    lw_t = T(lw) if weighted else torch.ones(1)
    lw_j = jnp.asarray(lw) if weighted else jnp.ones(1)
    _close(t_scores.lat_weighted_mse(T(em), T(tr), lw_t, nan_safe).numpy(),
           j_scores.lat_weighted_mse(jnp.asarray(em), jnp.asarray(tr), lw_j, nan_safe))
    _close(t_scores.lat_weighted_rmse(T(em), T(tr), lw_t, nan_safe).numpy(),
           j_scores.lat_weighted_rmse(jnp.asarray(em), jnp.asarray(tr), lw_j, nan_safe))


def test_nanmean_over_both_axes_is_jnp_nanmean():
    _, tr, _, _ = _inputs(2)
    tr[0] = np.nan  # an all-NaN slice gives NaN in both
    _close(torch.nanmean(T(tr), dim=(-2, -1)).numpy(),
           jnp.nanmean(jnp.asarray(tr), axis=(-2, -1)))


@pytest.mark.parametrize("masked", [False, True])
def test_ensemble_spread_matches_jax(masked):
    fc, tr, _, lw = _inputs(3)
    mask_t = torch.isfinite(T(tr)) if masked else None
    mask_j = jnp.isfinite(jnp.asarray(tr)) if masked else None
    _close(t_scores.ensemble_spread(T(fc), T(lw), 1, mask_t).numpy(),
           j_scores.ensemble_spread(jnp.asarray(fc), jnp.asarray(lw), 1, mask_j))


def test_rank_histogram_matches_jax():
    """Ranks are integers: with unit weights the counts, and so the
    frequencies, are exact; with cos-lat weights within 1e-6. NaN truth has
    zero weight, and ties break low."""
    fc, tr, _, lw = _inputs(4, E=5)
    fc[0, :, 0, 0] = tr[0, 0, 0]  # every member ties with the truth
    ones = np.ones_like(lw)
    got = t_scores.rank_histogram(T(fc), T(tr), T(ones), 1).numpy()
    want = np.asarray(j_scores.rank_histogram(jnp.asarray(fc), jnp.asarray(tr),
                                              jnp.asarray(ones), 1))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 6)
    _close(t_scores.rank_histogram(T(fc), T(tr), T(lw), 1).numpy(),
           j_scores.rank_histogram(jnp.asarray(fc), jnp.asarray(tr),
                                   jnp.asarray(lw), 1))
    # the land block counts nothing: its weight share is gone from channel 2
    counts = (t_scores.rank_histogram(T(fc), T(tr), T(ones), 1)
              * (12 * 16 - 4 * 6)).numpy()
    np.testing.assert_allclose(counts[-1].sum(), 12 * 16 - 4 * 6, rtol=1e-6)


@pytest.mark.parametrize("W", [16, 15])
@pytest.mark.parametrize("weighted", [False, True])
def test_zonal_power_spectrum_matches_jax_and_parseval(W, weighted):
    fc, _, _, lw = _inputs(5, W=W)
    x = fc[:, 0]
    w_t, w_j = (T(lw[:, 0]), jnp.asarray(lw[:, 0])) if weighted else (None, None)
    got = t_scores.zonal_power_spectrum(T(x), w_t).numpy()
    _close(got, j_scores.zonal_power_spectrum(jnp.asarray(x), w_j))
    if not weighted:  # sum_k P_k = mean_lon x^2, averaged over rows
        np.testing.assert_allclose(got.sum(-1), (x ** 2).mean(-1).mean(-1),
                                   rtol=1e-5)


def test_weights_match_jax():
    for kind in ("cos", "area"):
        np.testing.assert_array_equal(t_weights.grid_lat_weights(kind),
                                      j_weights.grid_lat_weights(kind))
    np.testing.assert_array_equal(t_weights.latent_lat_weights(),
                                  j_weights.latent_lat_weights())
    np.testing.assert_array_equal(t_weights.cell_area_weights([-60, 0, 30, 89]),
                                  j_weights.cell_area_weights([-60, 0, 30, 89]))
    with pytest.raises(ValueError):
        t_weights.grid_lat_weights("flat")


@pytest.mark.parametrize("reduce", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(reduce, weighted):
    rng = np.random.RandomState(6)
    y = rng.randn(2, 8, 10, 89).astype(np.float32)
    p = (y + 0.1 * rng.randn(*y.shape)).astype(np.float32)
    w = np.broadcast_to(np.linspace(0.5, 1.5, 8, dtype=np.float32).reshape(1, 8, 1, 1),
                        (2, 8, 1, 1)) if weighted else None
    wt = None if w is None else T(w)
    wj = None if w is None else jnp.asarray(w)
    _close(t_losses.lp_loss(T(p), T(y), wt, reduce=reduce).numpy(),
           j_losses.lp_loss(jnp.asarray(p), jnp.asarray(y), wj, reduce=reduce))
    _close(t_losses.lp_loss_per_var(T(p), T(y), wt).numpy(),
           j_losses.lp_loss_per_var(jnp.asarray(p), jnp.asarray(y), wj))
    _close(t_losses.mse_loss(T(p), T(y)).numpy(),
           j_losses.mse_loss(jnp.asarray(p), jnp.asarray(y)))


def test_climatology_matches_jax():
    rng = np.random.RandomState(7)
    ts = [2016022818, 2016022900, 2016022906, 2016030100, 2017010100,
          2017010100, 2017123118]  # a leap day: row 59; Dec 31 of 2017: row 364
    fields = rng.randn(len(ts), 3, 4).astype(np.float32)
    got = t_clim.compute_climatology(fields, ts)
    want = j_clim.compute_climatology(fields, ts)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[0, 0], fields[4:6].mean(0), rtol=1e-6)
    series = t_clim.climatology_to_timeseries(got, (0, 6, 12, 18), 2016022812, 24)
    np.testing.assert_array_equal(series, j_clim.climatology_to_timeseries(
        want, (0, 6, 12, 18), 2016022812, 24))
    assert series.shape == (4, 3, 4)
