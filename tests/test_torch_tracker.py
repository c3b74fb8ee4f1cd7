"""The port's cyclone tracker and ``cli.track`` against the JAX package's
on a synthetic moving low (numpy on both sides: results must be equal)."""

import csv
from datetime import datetime

import numpy as np
import pytest

from ladcast_torch import channels as t_ch
from ladcast_torch.cli import track as t_track
from ladcast_torch.evaluate import export as t_export
from ladcast_torch.evaluate import tracker as t_tr
from ladcast_tpu.cli import track as j_track
from ladcast_tpu.evaluate import tracker as j_tr

LAT = np.arange(-88.5, 90.0 + 1e-6, 1.5)
LON = np.arange(0.0, 358.5 + 1e-6, 1.5)


def _low(lat0, lon0, depth=3000.0, width=4.0):
    """An MSLP field with a Gaussian low at (lat0, lon0) over a gentle
    gradient, so that the low is the only local minimum near it."""
    dlon = (LON[None, :] - lon0 + 180) % 360 - 180
    r2 = (LAT[:, None] - lat0) ** 2 + dlon ** 2
    return (101000.0 + 20.0 * LAT[:, None] - depth * np.exp(-r2 / (2 * width ** 2))
            + 0 * LON[None, :]).astype(np.float32)


def _path(member):
    """Fixes every 6 h: a low moving north-west, members apart by a step."""
    return [(15.0 + 1.5 * i, 285.0 - 1.5 * i - 1.5 * member) for i in range(4)]


def test_tracker_functions_match_jax():
    t0 = datetime(2018, 9, 10, 0)
    fields = [_low(*p) for p in _path(0)]

    def mslp(mod):
        def at(t):
            i = int((t - t0).total_seconds() // 21600)
            return mod.GriddedField(fields[min(i, 3)], LAT, LON)
        return at

    for center, inner in (((15.0, 285.0), 7), ((16.5, 283.5), 4), ((0.0, 0.0), 1)):
        a = t_tr.find_local_minimum(t_tr.GriddedField(fields[1], LAT, LON), center, inner)
        b = j_tr.find_local_minimum(j_tr.GriddedField(fields[1], LAT, LON), center, inner)
        assert a == b
    got = t_tr.track_first_n_steps(t0, 15.2, 284.9, mslp(t_tr), n_steps=3)
    want = j_tr.track_first_n_steps(t0, 15.2, 284.9, mslp(j_tr), n_steps=3)
    assert got == want
    assert [(la, lo) for _, la, lo in got] == _path(0)
    # wrap across 0/360 and the rounding of the first fix
    assert t_tr.round_to_grid(284.9) == j_tr.round_to_grid(284.9) == 285.0
    f = t_tr.GriddedField(_low(10.0, 0.0), LAT, LON)
    assert f.box_mask(5, 15, 355, 5)[1].sum() == j_tr.GriddedField(
        _low(10.0, 0.0), LAT, LON).box_mask(5, 15, 355, 5)[1].sum() == 7
    assert t_tr.find_local_minimum(f, (10.5, 358.5), 4) == (10.5, 0.0, f.nearest(10.5, 0.0))
    obs = [(t, la + 0.3, lo) for t, la, lo in want]
    np.testing.assert_array_equal(t_tr.track_error_km(got, obs),
                                  j_tr.track_error_km(want, obs))


def test_loaders_match_jax(tmp_path):
    ib = tmp_path / "ibtracs.csv"
    ib.write_text("SID,ISO_TIME,LAT,LON\n ,,degrees,degrees\n"
                  "S1,2018-09-10 00:00:00,15.0,-75.0\n"
                  "S2,2018-09-10 00:00:00,1.0,2.0\n"
                  "S1,2018-09-10 06:00:00,16.5,-76.5\n"
                  "S1,bad,1,1\n")
    assert t_tr.load_ibtracs_csv(str(ib), "S1") == j_tr.load_ibtracs_csv(str(ib), "S1")
    assert len(t_tr.load_ibtracs_csv(str(ib), "S1")) == 2
    with pytest.raises(ValueError):
        t_tr.load_ibtracs_csv(str(ib), "S9")
    hd = tmp_path / "hurdat.txt"
    hd.write_text("AL012018, ONE, 2,\n"
                  "20180910, 0000, , TS, 15.0N, 75.0W, 40, 1000\n"
                  "20180910, 0600, , TS, 16.5N, 76.5W, 45, 995\n"
                  "AL022018, TWO, 1,\n"
                  "20180911, 0000, , TS, 10.0S, 20.0E, 40, 1000\n")
    for sid in ("AL012018", "AL022018"):
        assert t_tr.load_hurdat(str(hd), sid) == j_tr.load_hurdat(str(hd), sid)
    kml = tmp_path / "tracks.kml"
    kml.write_text(
        '<?xml version="1.0"?><kml xmlns="http://www.opengis.net/kml/2.2"><Document>'
        '<Folder><name>GFS</name>'
        '<Placemark><TimeStamp><when>2018-09-10T06:00:00Z</when></TimeStamp>'
        '<Point><coordinates>-76.5,16.5,0</coordinates></Point></Placemark>'
        '<Placemark><TimeStamp><when>2018-09-10T00:00:00Z</when></TimeStamp>'
        '<Point><coordinates>-75.0,15.0,0</coordinates></Point></Placemark>'
        '</Folder><Folder><name>ECMWF</name></Folder></Document></kml>')
    for kw in ({}, {"valid_models": ["GFS"], "n_steps": 0}):
        assert t_tr.load_kml_tracks(str(kml), **kw) == j_tr.load_kml_tracks(str(kml), **kw)


def test_cli_track_matches_jax(tmp_path, monkeypatch):
    """A decoded bundle as ``pred_rollout --decode`` writes it: two members
    whose MSLP holds a moving low, tracked by both CLIs, with IBTrACS
    errors."""
    E, T = 2, 3
    fields = np.zeros((E, T, 120, 240, 84), np.float32)
    mslp = t_ch.channel_index("mean_sea_level_pressure")
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
            "--ibtracs", str(ib), "--storm_id", "S1"]
    j_track.main(args + ["--output_csv", str(tmp_path / "jax.csv")])
    tracks = t_track.main(args + ["--output_csv", str(tmp_path / "torch.csv")])
    rows = {k: list(csv.reader((tmp_path / f"{k}.csv").open())) for k in ("jax", "torch")}
    assert rows["torch"] == rows["jax"]
    assert rows["torch"][0] == ["member", "time", "lat", "lon", "error_km"]
    assert [(la, lo) for _, la, lo in tracks["member_0"]] == _path(0)
    assert float(rows["torch"][6][4]) > 100  # member 1 runs a step west
    # the plots need matplotlib, checked before the forecast is read
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for flag in ("--plot", "--plot_errors"):
        with pytest.raises(SystemExit, match="matplotlib"):
            t_track.main(args + ["--output_csv", str(tmp_path / "x.csv"), flag, "p.png"])
    assert not (tmp_path / "x.csv").exists()
