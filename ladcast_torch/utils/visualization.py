"""Plots of fields, forecasts, cyclone tracks and ensemble diagnostics
(the port of ``ladcast_tpu/utils/visualization.py``): matplotlib on the Agg
back end, with cartopy's map projections where cartopy is installed and
plain lat/lon axes otherwise. The functions take numpy arrays and draw the
same figures as the JAX package's, artist for artist.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def require_matplotlib(flag: str) -> None:
    """Exit naming matplotlib where it is not importable: the CLIs call this
    for their plot flags before they load or compute anything."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"{flag} needs matplotlib, which is not installed "
                         f"here ({e})")


def _has_cartopy() -> bool:
    """True only for a functional cartopy (a test-stubbed module that
    merely imports, or a partial install whose feature submodule is
    broken, must not select the projection path)."""
    try:
        import cartopy.crs as ccrs
        import cartopy.feature as cfeature
        return hasattr(ccrs, "PlateCarree") and hasattr(cfeature, "BORDERS")
    except ImportError:
        return False


def _get_axes(n, figsize):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if _has_cartopy():
        import cartopy.crs as ccrs
        fig, axes = plt.subplots(
            1, n, figsize=figsize,
            subplot_kw={"projection": ccrs.Robinson()})
        proj = True
    else:
        fig, axes = plt.subplots(1, n, figsize=figsize)
        proj = False
    if n == 1:
        axes = [axes]
    return fig, list(np.atleast_1d(axes)), proj


def _draw(ax, field, lat, lon, proj, cmap="jet", vmin=None, vmax=None):
    if proj:
        import cartopy.crs as ccrs
        im = ax.pcolormesh(lon, lat, field, cmap=cmap, vmin=vmin, vmax=vmax,
                           transform=ccrs.PlateCarree())
        ax.coastlines(linewidth=0.4)
    else:
        im = ax.pcolormesh(lon, lat, field, cmap=cmap, vmin=vmin, vmax=vmax)
    return im


def plot_reconstruction_comparison(
    original: np.ndarray,       # (lat, lon)
    reconstructed: np.ndarray,  # (lat, lon)
    lat: np.ndarray,
    lon: np.ndarray,
    title: str = "",
    out_path: Optional[str] = None,
):
    """3-panel original / reconstruction / error figure
    (reference utils.py:108-215)."""
    import matplotlib.pyplot as plt

    fig, axes, proj = _get_axes(3, (15, 4))
    vmin, vmax = np.nanmin(original), np.nanmax(original)
    for ax, (f, name) in zip(axes, [
            (original, "original"), (reconstructed, "reconstruction"),
            (reconstructed - original, "error")]):
        v0, v1 = (vmin, vmax) if name != "error" else (None, None)
        cmap = "jet" if name != "error" else "RdBu_r"
        im = _draw(ax, f, lat, lon, proj, cmap, v0, v1)
        ax.set_title(f"{title} {name}".strip())
        fig.colorbar(im, ax=ax, shrink=0.7)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    return fig


def plot_forecast_panels(
    frames: np.ndarray,          # (T, lat, lon)
    lat: np.ndarray,
    lon: np.ndarray,
    lead_hours: Sequence[int],
    truth: Optional[np.ndarray] = None,
    title: str = "",
    out_path: Optional[str] = None,
):
    """Static multi-lead-time forecast panels (reference
    plot_traj_static, utils.py:697-935)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = 2 if truth is not None else 1
    n = len(lead_hours)
    fig, axes = plt.subplots(rows, n, figsize=(3.2 * n, 2.6 * rows),
                             squeeze=False)
    vmin = np.nanmin(frames)
    vmax = np.nanmax(frames)
    for j, lh in enumerate(lead_hours):
        im = axes[0][j].pcolormesh(lon, lat, frames[j], cmap="jet",
                                   vmin=vmin, vmax=vmax)
        axes[0][j].set_title(f"{title} +{lh}h")
        if truth is not None:
            axes[1][j].pcolormesh(lon, lat, truth[j], cmap="jet",
                                  vmin=vmin, vmax=vmax)
            axes[1][j].set_title(f"ERA5 +{lh}h")
    fig.colorbar(im, ax=[a for row in axes for a in row], shrink=0.6)
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    return fig


def save_forecast_gif(
    frames: np.ndarray,  # (T, lat, lon)
    out_path: str,
    fps: int = 4,
    cmap: str = "jet",
):
    """Forecast animation (reference plot_traj_animation, utils.py:218-542)
    written as an animated GIF via matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 3))
    vmin, vmax = np.nanmin(frames), np.nanmax(frames)
    im = ax.imshow(frames[0][::-1], cmap=cmap, vmin=vmin, vmax=vmax)
    ax.set_axis_off()

    def update(i):
        im.set_data(frames[i][::-1])
        return [im]

    ani = animation.FuncAnimation(fig, update, frames=len(frames))
    ani.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)


def save_comparison_animation(
    pred: np.ndarray,            # (T, lat, lon)
    truth: np.ndarray,           # (T, lat, lon)
    out_path: str,
    lead_hours: Optional[Sequence[int]] = None,
    var_name: str = "",
    fps: int = 3,
    cmap: str = "jet",
):
    """Side-by-side forecast / ERA5 / error animation (reference
    plot_traj_animation + plot_single_traj_animation, utils.py:218-694)
    as an animated GIF."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    T = pred.shape[0]
    lead_hours = list(lead_hours) if lead_hours is not None \
        else [6 * (i + 1) for i in range(T)]
    vmin = min(np.nanmin(pred), np.nanmin(truth))
    vmax = max(np.nanmax(pred), np.nanmax(truth))
    err = pred - truth
    emax = float(np.nanmax(np.abs(err))) if err.size else 0.0
    if not np.isfinite(emax) or emax <= 0:  # all-NaN/zero error panel
        emax = 1.0

    fig, axes = plt.subplots(1, 3, figsize=(12, 2.8))
    ims = [
        axes[0].imshow(pred[0][::-1], cmap=cmap, vmin=vmin, vmax=vmax),
        axes[1].imshow(truth[0][::-1], cmap=cmap, vmin=vmin, vmax=vmax),
        axes[2].imshow(err[0][::-1], cmap="RdBu_r", vmin=-emax, vmax=emax),
    ]
    for ax in axes:
        ax.set_axis_off()
    titles = [f"{var_name} forecast", "ERA5", "error"]

    def update(i):
        for im, arr in zip(ims, (pred, truth, err)):
            im.set_data(arr[i][::-1])
        for ax, t in zip(axes, titles):
            ax.set_title(f"{t} +{lead_hours[i]}h", fontsize=9)
        return ims

    update(0)
    ani = animation.FuncAnimation(fig, update, frames=T)
    ani.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)


def to_rgb(field: np.ndarray, cmap: str = "jet") -> np.ndarray:
    """Field -> uint8 RGB via a colormap (reference convert_to_rgb,
    utils.py:77-105)."""
    import matplotlib

    f = np.asarray(field, np.float64)
    f = (f - np.nanmin(f)) / max(np.nanmax(f) - np.nanmin(f), 1e-12)
    rgba = matplotlib.colormaps[cmap](f)
    return (rgba[..., :3] * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Cyclone-track plotting (reference evaluate/track.py:389-583 plot_tracks).
# Tracks are lists of (datetime, lat, lon) fixes -- the format produced by
# evaluate/tracker.track_first_n_steps. Cartopy coastlines/borders are
# drawn when the library exists; otherwise plain lat/lon axes with a
# gridline raster carry the same scientific content.
# ---------------------------------------------------------------------------


def _track_axes(extent=None, figsize=(10, 7)):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if _has_cartopy():
        import cartopy.crs as ccrs
        import cartopy.feature as cfeature
        fig = plt.figure(figsize=figsize)
        ax = plt.axes(projection=ccrs.PlateCarree())
        ax.coastlines("50m")
        ax.add_feature(cfeature.BORDERS)
        ax.gridlines(draw_labels=True)
        if extent is not None:
            ax.set_extent(extent, crs=ccrs.PlateCarree())
    else:
        fig, ax = plt.subplots(figsize=figsize)
        ax.grid(True, linewidth=0.3, alpha=0.6)
        ax.set_xlabel("longitude (deg)")
        ax.set_ylabel("latitude (deg)")
        if extent is not None:
            ax.set_xlim(extent[0], extent[1])
            ax.set_ylim(extent[2], extent[3])
    return fig, ax


def _annotate_24h(ax, track, interval_annot=24, **text_kw):
    t0 = track[0][0]
    for t, la, lo in track:
        hours = int((t - t0).total_seconds() // 3600)
        if hours % interval_annot == 0:
            ax.text(lo, la, f"{hours}", fontsize=6, ha="center",
                    va="bottom", **text_kw)


def plot_tracks(
    obs_track=None,          # observed (IBTrACS/HURDAT) fixes
    era5_track=None,         # analysis track
    ens_tracks=None,         # {member_name: track}
    ens_mean_track=None,
    model_tracks=None,       # {model_name: track} (e.g. KML agency tracks)
    interval: int = 1,
    title: str = "Storm Track Comparison",
    extent=None,             # (lon_min, lon_max, lat_min, lat_max)
    ensemble_label: str = "Ensemble",
    out_path: Optional[str] = None,
):
    """Observed + ERA5 + ensemble + agency track comparison map
    (reference track.py:389-583): observed solid with 24-h hour
    annotations, ERA5 dashed squares, members thin staggered-dash green
    with end markers, ensemble mean red dashed with annotations and a
    final X, agency models triangle lines."""
    import matplotlib.pyplot as plt

    fig, ax = _track_axes(extent)

    def lonlat(track):
        sub = track[::interval]
        return [p[2] for p in sub], [p[1] for p in sub]

    if obs_track:
        lons, lats = lonlat(obs_track)
        ax.plot(lons, lats, "o-", label="IBTrACS", linewidth=2)
        _annotate_24h(ax, obs_track[::interval], fontweight="bold")
    if era5_track:
        lons, lats = lonlat(era5_track)
        ax.plot(lons, lats, "s--", label="ERA5 (1.5\N{DEGREE SIGN})",
                linewidth=2)
    if ens_tracks:
        for idx, (name, track) in enumerate(ens_tracks.items()):
            lons, lats = lonlat(track)
            (line,) = ax.plot(
                lons, lats, color="green", linewidth=1, alpha=0.4,
                label=ensemble_label if idx == 0 else "_nolegend_")
            line.set_linestyle((idx * 3, (6, 4)))  # staggered dashes
            ax.plot(lons[-1], lats[-1], "o", color=line.get_color(),
                    markersize=2)
    if ens_mean_track:
        lons, lats = lonlat(ens_mean_track)
        ax.plot(lons, lats, "--", color="red", linewidth=2,
                label="Ensemble mean")
        _annotate_24h(ax, ens_mean_track, color="black")
        ax.plot(lons[-1], lats[-1], "X", color="red", markersize=6)
    if model_tracks:
        for model, track in model_tracks.items():
            lons, lats = lonlat(track)
            ax.plot(lons, lats, "-^", label=model)

    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=200)
        plt.close(fig)
    return fig


def ensemble_mean_track(tracks) -> list:
    """Fix-wise mean of equal-length member tracks (lat/lon averaged on
    the sphere would matter near the antimeridian; the reference averages
    raw coordinates, matched here)."""
    tracks = list(tracks.values()) if isinstance(tracks, dict) else tracks
    n = min(len(t) for t in tracks)
    out = []
    for i in range(n):
        out.append((tracks[0][i][0],
                    float(np.mean([t[i][1] for t in tracks])),
                    float(np.mean([t[i][2] for t in tracks]))))
    return out


def plot_track_errors(
    errors_km: dict,            # {name: (T,) km errors vs observed}
    step_hours: int = 6,
    title: str = "Track error vs lead time",
    out_path: Optional[str] = None,
):
    """Per-member + mean great-circle track error growth (the quantity the
    reference exports to CSV at track.py:891-912, plotted)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    all_err = []
    for name, err in errors_km.items():
        hours = np.arange(len(err)) * step_hours
        ax.plot(hours, err, color="green", alpha=0.35, linewidth=1)
        all_err.append(np.asarray(err, float))
    if all_err:
        n = min(map(len, all_err))
        mean = np.mean([e[:n] for e in all_err], axis=0)
        ax.plot(np.arange(n) * step_hours, mean, color="red", linewidth=2,
                label="ensemble mean error")
        ax.legend()
    ax.set_xlabel("lead time (h)")
    ax.set_ylabel("track error (km)")
    ax.set_title(title)
    ax.grid(True, linewidth=0.3, alpha=0.6)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return fig


def plot_ens_diagnostics(
    scores_dir: str,
    out_path: str,
    headline: Sequence[tuple] = (("geopotential", 500),
                                 ("temperature", 850),
                                 ("u_component_of_wind", 850),
                                 ("2m_temperature", None)),
    step_size_hour: int = 6,
):
    """Ensemble-calibration panel from an ``evaluate_ens --diagnostics``
    output dir (beyond the reference, which only tabulates RMSE/CRPS):
    per-variable RMSE vs fair-corrected spread, rank histograms, and
    zonal power spectra of the ensemble mean vs truth at day 1/5/10."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ladcast_torch import channels as ch

    def _load(name):
        import os
        return np.load(os.path.join(scores_dir, f"{name}.npy"))

    rmse = np.sqrt(_load("ens_mean_mse").mean(0))          # (C, T)
    spread = _load("spread").mean(0)                       # (C, T)
    rank_hist = _load("rank_hist").mean(0)                 # (C, T, M+1)
    spec_fc, spec_tr = _load("spectrum_fc").mean(0), \
        _load("spectrum_truth").mean(0)                    # (C, T, K)
    T = rmse.shape[1]
    leads_d = (np.arange(T) + 1) * step_size_hour / 24.0
    m = rank_hist.shape[-1] - 1
    fair = np.sqrt((m + 1) / m)
    day_ts = [d * 24 // step_size_hour - 1 for d in (1, 5, 10)
              if d * 24 // step_size_hour - 1 < T] or [T - 1]

    cols = len(headline)
    fig, axes = plt.subplots(3, cols, figsize=(3.6 * cols, 9))
    axes = np.atleast_2d(axes)
    for j, (var, level) in enumerate(headline):
        ci = ch.channel_index(var, level)
        name = f"{var}@{level}" if level else var

        ax = axes[0, j]
        ax.plot(leads_d, rmse[ci], label="ens-mean RMSE", color="tab:blue")
        ax.plot(leads_d, spread[ci] * fair, label="spread (fair)",
                color="tab:orange")
        ax.set_title(name, fontsize=9)
        ax.set_xlabel("lead (days)")
        ax.grid(alpha=0.3)
        if j == 0:
            ax.legend(fontsize=7)

        ax = axes[1, j]
        t_mid = day_ts[min(1, len(day_ts) - 1)]
        ax.bar(np.arange(m + 1), rank_hist[ci, t_mid], color="tab:green")
        ax.axhline(1.0 / (m + 1), color="k", linestyle="--", linewidth=0.8)
        ax.set_xlabel(f"rank (day {(t_mid + 1) * step_size_hour / 24:.0f})")
        if j == 0:
            ax.set_ylabel("rank frequency")

        ax = axes[2, j]
        k = np.arange(1, spec_fc.shape[-1])
        for t, c in zip(day_ts, ("tab:blue", "tab:purple", "tab:red")):
            ax.loglog(k, spec_fc[ci, t, 1:], color=c, linewidth=1,
                      label=f"fc d{(t + 1) * step_size_hour // 24}")
        ax.loglog(k, spec_tr[ci, day_ts[0], 1:], color="k", linewidth=1,
                  linestyle="--", label="truth")
        ax.set_xlabel("zonal wavenumber")
        if j == 0:
            ax.set_ylabel("power")
            ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
