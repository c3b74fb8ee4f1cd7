"""The port's plots (``ladcast_torch.utils.visualization``) against the JAX
package's, pixel for pixel on the same seeded inputs (matplotlib's Agg back
end, no cartopy), and the plot flags of ``cli.evaluate_ens`` and
``cli.track``: their PNGs equal what the JAX functions draw from the same
scores or tracks, and without matplotlib the flags refuse before any work."""

import sys
from datetime import datetime, timedelta

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
import matplotlib.image as mpimg  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402

from ladcast_torch.cli import evaluate_ens as t_ens  # noqa: E402
from ladcast_torch.cli import track as t_track  # noqa: E402
from ladcast_torch.evaluate import export as t_export  # noqa: E402
from ladcast_torch.utils import visualization as t_viz  # noqa: E402
from ladcast_tpu.utils import visualization as j_viz  # noqa: E402
from tests.test_torch_evaluate_ens import world  # noqa: E402,F401
from tests.test_torch_tracker import _low, _path  # noqa: E402

LAT = np.linspace(-80.0, 80.0, 6)
LON = np.linspace(0.0, 330.0, 12)


def _pixels(fig):
    """The figure's RGBA pixels, drawn, and the figure closed."""
    fig.canvas.draw()
    rgba = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return rgba


def _same_png(a, b):
    x, y = mpimg.imread(a), mpimg.imread(b)
    assert x.shape == y.shape
    np.testing.assert_array_equal(x, y)
    return x.shape


def _track(lat0, lon0, n, member=0):
    t0 = datetime(2018, 9, 10)
    return [(t0 + timedelta(hours=6 * i), lat0 + 1.5 * i, lon0 - 1.5 * (i + member))
            for i in range(n)]


def test_no_cartopy_here():
    """The tests draw the plain-axes figures (cartopy is not installed)."""
    assert not t_viz._has_cartopy() and not j_viz._has_cartopy()


@pytest.mark.parametrize("name", ["plot_reconstruction_comparison",
                                  "plot_forecast_panels"])
def test_field_figures_match_jax(name):
    rng = np.random.RandomState(0)
    if name == "plot_reconstruction_comparison":
        a, b = rng.randn(2, 6, 12)
        args, kw = (a, a + 0.1 * b, LAT, LON), {"title": "T850"}
    else:
        frames = rng.randn(3, 6, 12)
        args, kw = (frames, LAT, LON, [6, 12, 18]), {
            "truth": frames + 0.2 * rng.randn(3, 6, 12), "title": "z500"}
    got = _pixels(getattr(t_viz, name)(*args, **kw))
    want = _pixels(getattr(j_viz, name)(*args, **kw))
    np.testing.assert_array_equal(got, want)
    assert got.std() > 0


@pytest.mark.parametrize("name", ["save_forecast_gif", "save_comparison_animation"])
def test_animations_match_jax(name, tmp_path):
    pytest.importorskip("PIL")
    rng = np.random.RandomState(1)
    pred = rng.randn(2, 6, 12)
    args = (pred,) if name == "save_forecast_gif" else (pred, pred + rng.randn(2, 6, 12))
    for pkg, mod in (("torch", t_viz), ("jax", j_viz)):
        getattr(mod, name)(*args, str(tmp_path / f"{pkg}.gif"))
    assert (tmp_path / "torch.gif").read_bytes() == (tmp_path / "jax.gif").read_bytes()


def test_array_helpers_match_jax():
    field = np.random.RandomState(2).randn(6, 12)
    field[0, 0] = np.nan
    for cmap in ("jet", "RdBu_r"):
        np.testing.assert_array_equal(t_viz.to_rgb(field, cmap), j_viz.to_rgb(field, cmap))
    tracks = {f"member_{m}": _track(15.0, 285.0, 4 - m % 2, m) for m in range(3)}
    assert t_viz.ensemble_mean_track(tracks) == j_viz.ensemble_mean_track(tracks)
    assert t_viz.ensemble_mean_track(list(tracks.values())) == \
        j_viz.ensemble_mean_track(list(tracks.values()))


def test_track_figures_match_jax():
    ens = {f"member_{m}": _track(15.0, 285.0, 5, m) for m in range(3)}
    kw = dict(obs_track=_track(15.2, 285.0, 5), era5_track=_track(15.0, 284.0, 5),
              ens_tracks=ens, ens_mean_track=t_viz.ensemble_mean_track(ens),
              model_tracks={"GFS": _track(14.0, 286.0, 3)}, extent=(270, 300, 5, 30))
    np.testing.assert_array_equal(_pixels(t_viz.plot_tracks(**kw)),
                                  _pixels(j_viz.plot_tracks(**kw)))
    errs = {n: np.abs(np.random.RandomState(3).randn(5)) * 100 for n in ens}
    np.testing.assert_array_equal(_pixels(t_viz.plot_track_errors(errs)),
                                  _pixels(j_viz.plot_track_errors(errs)))


def test_cli_evaluate_ens_plot_matches_jax(world, tmp_path, monkeypatch):  # noqa: F811
    """``--diagnostics --plot_diagnostics`` draws JAX's panel of the scores
    it wrote; without ``--diagnostics`` the flag draws nothing, as in JAX;
    without matplotlib the run refuses before it loads anything."""
    base = ["--latent_dir", world["lat_dir"], "--truth", world["era5"],
            "--dcae_params", world["dcae_dir"], "--step_size_hour", "24",
            "--allow_truth_mean_climatology", "--device", "cpu"]
    png = tmp_path / "diag.png"
    out = tmp_path / "scores"
    t_ens.main(base + ["--output_dir", str(out), "--diagnostics",
                       "--plot_diagnostics", str(png)])
    j_viz.plot_ens_diagnostics(str(out), str(tmp_path / "jax.png"), step_size_hour=24)
    assert _same_png(png, tmp_path / "jax.png")[:2] == (1080, 1728)
    t_ens.main(base + ["--output_dir", str(tmp_path / "no_diag"),
                       "--plot_diagnostics", str(tmp_path / "none.png")])
    assert not (tmp_path / "none.png").exists()

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    loads = []
    monkeypatch.setattr(t_ens.dist, "initialize", lambda **kw: loads.append(kw))
    with pytest.raises(SystemExit, match="matplotlib"):
        t_ens.main(base + ["--output_dir", str(tmp_path / "x"), "--diagnostics",
                           "--plot_diagnostics", str(tmp_path / "x.png")])
    assert loads == [] and not (tmp_path / "x").exists()


def test_cli_track_plots_match_jax(tmp_path, monkeypatch):
    """``--plot`` and ``--plot_errors`` draw JAX's figures of the tracks the
    CLI found; without matplotlib they refuse before the forecast is read."""
    E, T = 2, 3
    fields = np.zeros((E, T, 120, 240, 84), np.float32)
    mslp = t_export.ch.channel_index("mean_sea_level_pressure")
    for m in range(E):
        for t in range(T):
            fields[m, t, ..., mslp] = _low(*_path(m)[t + 1])
    bundle = str(tmp_path / "fields_2018091000.npz")
    t_export.decoded_to_npz(fields, 2018091000, bundle)
    ib = tmp_path / "ib.csv"
    ib.write_text("SID,ISO_TIME,LAT,LON\n ,,,\n"
                  + "".join(f"S1,2018-09-10 {6 * i:02d}:00:00,{la},{lo - 360}\n"
                            for i, (la, lo) in enumerate(_path(0))))
    args = ["--forecast", bundle, "--lat0", "15.0", "--lon0", "285.0",
            "--ibtracs", str(ib), "--storm_id", "S1", "--output_csv",
            str(tmp_path / "t.csv")]
    png, err_png = tmp_path / "map.png", tmp_path / "err.png"
    tracks = t_track.main(args + ["--plot", str(png), "--plot_errors", str(err_png)])
    from ladcast_tpu.evaluate import tracker as j_tr

    obs = j_tr.load_ibtracs_csv(str(ib), "S1")
    j_viz.plot_tracks(obs_track=obs, ens_tracks=tracks,
                      ens_mean_track=j_viz.ensemble_mean_track(tracks),
                      title="S1 track comparison", out_path=str(tmp_path / "jmap.png"))
    j_viz.plot_track_errors({n: j_tr.track_error_km(t, obs) for n, t in tracks.items()},
                            step_hours=6, out_path=str(tmp_path / "jerr.png"))
    assert _same_png(png, tmp_path / "jmap.png")[:2] == (1400, 2000)
    assert _same_png(err_png, tmp_path / "jerr.png")[:2] == (600, 1050)

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for flag in ("--plot", "--plot_errors"):
        with pytest.raises(SystemExit, match="matplotlib"):
            t_track.main(["--forecast", str(tmp_path / "absent.npz"), "--lat0", "15",
                          "--lon0", "285", "--output_csv", str(tmp_path / "x.csv"),
                          flag, str(tmp_path / "x.png")])
    assert not (tmp_path / "x.csv").exists()
