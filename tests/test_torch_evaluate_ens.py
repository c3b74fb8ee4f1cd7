"""The port's scorer chain against the JAX package's, in fp32 on the CPU:
``make_score_fn`` and the whole ``cli.evaluate_ens`` (its metric files and
``summary.json``) on a tiny DCAE at the real 120-row grid (narrow in
longitude), ``cli.compute_climatology``'s ``clim.npz`` feeding it, and
``cli.compare_baseline``'s verdict."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladcast_torch.cli import compare_baseline as t_cmp
from ladcast_torch.cli import compute_climatology as t_clim_cli
from ladcast_torch.cli import evaluate_ens as t_ens
from ladcast_torch.models import hub as t_hub
from ladcast_tpu import config as j_config
from ladcast_tpu import static_data as j_static
from ladcast_tpu.cli import compare_baseline as j_cmp
from ladcast_tpu.cli import compute_climatology as j_clim_cli
from ladcast_tpu.cli import evaluate_ens as j_ens
from ladcast_tpu.metrics.weights import grid_lat_weights
from ladcast_tpu.models import hub as j_hub
from ladcast_tpu.models.dcae import AutoencoderDC as JaxAE

# two ResBlock stages: latent (60, W/2, 8) -> fields (120, W, 84 + 5)
TINY_DCAE = dict(in_channels=89, out_channels=89, latent_channels=8,
                 attention_head_dim=4,
                 encoder_block_types=("ResBlock", "ResBlock"),
                 decoder_block_types=("ResBlock", "ResBlock"),
                 encoder_block_out_channels=(8, 16),
                 decoder_block_out_channels=(8, 16),
                 encoder_layers_per_block=(1, 1), decoder_layers_per_block=(1, 1),
                 encoder_qkv_multiscales=((), ()), decoder_qkv_multiscales=((), ()),
                 static_channels=5)
W = 8  # longitudes: the grid's 120 rows are what the scorer's weights need
INITS = [2018010100, 2018010200, 2018010300]  # the last lacks its truth
TRUTH_TS = [2018010100, 2018010200, 2018010300, 2018010400]
REL = 1e-5


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The test suite runs files in parallel workers on a shared CPU; two
    intra-op threads per worker keep them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, channel_axis, rel=REL):
    """Each channel's largest error against that channel's largest |want|:
    the channels' scales run from 1e-6 (specific humidity) to 1e7
    (geopotential), so one scale for the whole array would pass any error
    in the small ones, SST (the only channel with NaNs) among them.
    ``channel_axis=None`` takes one scale for the array: for ACC, a
    correlation, whose channels share the unitless scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if channel_axis is None:
        got, want, channel_axis = got[None], want[None], 0
    n = want.shape[channel_axis]
    got = np.moveaxis(got, channel_axis, 0).reshape(n, -1)
    want = np.moveaxis(want, channel_axis, 0).reshape(n, -1)
    for c in range(n):
        ok = ~np.isnan(want[c])
        if ok.any():
            err = (np.abs(got[c][ok] - want[c][ok]).max()
                   / max(np.abs(want[c][ok]).max(), 1e-30))
            assert err <= rel, (c, err)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A JAX tiny DCAE written by the JAX hub, daily raw truth with SST NaNs
    over a land block, and E=3 members' latent files (t=0 + 2 leads, 24 h
    apart) for three init times."""
    tmp = tmp_path_factory.mktemp("ens")
    cfg = j_config.DCAEConfig(**TINY_DCAE)
    params = jax.tree.map(np.asarray, jax.jit(JaxAE(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 120, W, 84)), jnp.zeros((120, W, 5))))
    dcae_dir = str(tmp / "dcae")
    j_hub.save_pretrained(dcae_dir, "dcae", cfg, params)
    fm, fs = j_static.era5_mean_std()
    rng = np.random.RandomState(0)
    truth = (rng.randn(len(TRUTH_TS), 120, W, 84) * fs + fm).astype(np.float32)
    truth[:, 10:30, 2:5, 82] = np.nan
    era5 = str(tmp / "era5.npz")
    np.savez(era5, fields=truth, timestamps=np.asarray(TRUTH_TS, np.int64))
    lat_dir = tmp / "latents"
    lat_dir.mkdir()
    for ts in INITS:
        np.save(lat_dir / f"latent_{ts}.npy",
                rng.randn(3, 8, 3, 60, W // 2).astype(np.float32))
    return dict(tmp=tmp, cfg=cfg, params=params, dcae_dir=dcae_dir, era5=era5,
                lat_dir=str(lat_dir), truth=truth)


def test_make_score_fn_matches_jax(world):
    """Every metric and diagnostic per (channel, lead), SST NaNs included."""
    rng = np.random.RandomState(1)
    lat = rng.randn(3, 2, 60, W // 2, 8).astype(np.float32)
    truth = world["truth"][1:3]
    clim = (truth + rng.randn(*truth.shape).astype(np.float32) * 5)
    clim[np.isnan(clim)] = 0.0
    lw = grid_lat_weights("cos")
    want = j_ens.make_score_fn(JaxAE(world["cfg"]), world["params"],
                               jnp.asarray(lw, jnp.float32), diagnostics=True)(
        jnp.asarray(lat), jnp.asarray(truth), jnp.asarray(clim))
    loaded = t_hub.load_pretrained(world["dcae_dir"], expect_kind="dcae")
    dcae = t_hub.build_model("dcae", loaded.config, loaded.params, "cpu")
    stats = {}
    got = t_ens.make_score_fn(dcae, torch.as_tensor(lw, dtype=torch.float32),
                              diagnostics=True)(lat, truth, clim, stats)
    assert set(got) == set(want) == set(t_ens.METRIC_KEYS + t_ens.DIAGNOSTIC_KEYS)
    for k in want:
        _close(got[k].numpy(), want[k], channel_axis=None if k == "acc" else 0)
    assert got["rank_hist"].shape == (84, 2, 4)
    assert np.isfinite(got["ens_mean_mse"].numpy()).all()  # nan-safe over SST
    assert stats["decode_s"] > 0 and stats["score_s"] > 0


def _run_both(world, out, extra):
    args = ["--latent_dir", world["lat_dir"], "--truth", world["era5"],
            "--dcae_params", world["dcae_dir"], "--step_size_hour", "24",
            "--diagnostics", *extra]
    j_ens.main(args + ["--output_dir", str(out / "jax")])
    res = t_ens.main(args + ["--output_dir", str(out / "torch"), "--device", "cpu"])
    return out / "jax", out / "torch", res


@pytest.mark.parametrize("climatology", ["clim_npz", "truth_mean"])
def test_cli_matches_jax(world, tmp_path, climatology):
    if climatology == "clim_npz":
        # the climatology CLIs of both packages, daily at 00z
        outs = {}
        for name, cli in (("jax", j_clim_cli), ("torch", t_clim_cli)):
            outs[name] = str(tmp_path / f"clim_{name}.npz")
            cli.main(["--data", world["era5"], "--output", outs[name],
                      "--hours", "0", "--batch", "3"])
        with np.load(outs["jax"]) as a, np.load(outs["torch"]) as b:
            np.testing.assert_array_equal(a["clim"], b["clim"])
            np.testing.assert_array_equal(a["hours"], b["hours"])
            assert a["clim"].shape == (366, 1, 120, W, 84)
        extra = ["--climatology", outs["torch"]]
    else:
        extra = ["--allow_truth_mean_climatology"]
    jdir, tdir, res = _run_both(world, tmp_path, extra)
    assert res["num_init_times"] == 2  # the third init time lacks its truth
    assert [r.get("skipped") is not None for r in res["records"]] == [False, False, True]
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert "ens_mean_mse.rank0.npy" in names and "spectrum_fc.npy" in names
    for f in names:
        if f.endswith(".npy"):
            _close(np.load(tdir / f), np.load(jdir / f),
                   channel_axis=None if f.startswith("acc.") else 1)
    js = json.loads((jdir / "summary.json").read_text())
    ts = json.loads((tdir / "summary.json").read_text())
    assert js.keys() == ts.keys()
    for var in js:
        for lead in js[var]:
            for k, v in js[var][lead].items():  # rounded to 4 decimals
                assert abs(ts[var][lead][k] - v) <= 1e-4 + REL * abs(v), (var, k)
    # the baseline comparison reaches the same verdict
    jv = j_cmp.compare(str(jdir), step_size_hour=24)
    tv = t_cmp.compare(str(tdir), step_size_hour=24)
    assert tv["num_pass"] == jv["num_pass"] and tv["num_scored"] == jv["num_scored"]
    for var, days in jv["verdicts"].items():
        for day, v in days.items():
            assert tv["verdicts"][var][day]["status"] == v["status"]
            if v["ours"] is not None:
                assert abs(tv["verdicts"][var][day]["ours"] - v["ours"]) <= (
                    1e-6 + REL * abs(v["ours"]))


def test_compare_baseline_cli_and_plot(tmp_path):
    """The CLI writes the verdict, exits 1 when a point fails, and draws its
    panel inline with matplotlib."""
    pytest.importorskip("matplotlib")
    mse = np.full((2, 84, 40), 1e-12, np.float32)  # (inits, C, T): all pass
    np.save(tmp_path / "ens_mean_mse.npy", mse)
    out, png = tmp_path / "verdict.json", tmp_path / "curves.png"
    t_cmp.main(["--scores", str(tmp_path), "--output", str(out), "--plot", str(png)])
    verdict = json.loads(out.read_text())
    assert verdict["all_pass"] and verdict["num_scored"] == 36
    assert png.stat().st_size > 0
    np.save(tmp_path / "ens_mean_mse.npy", mse + 1e12)
    with pytest.raises(SystemExit):
        t_cmp.main(["--scores", str(tmp_path)])
    assert t_cmp.BASELINE_RMSE == j_cmp.BASELINE_RMSE


def test_file_helpers_match_jax(world, tmp_path):
    files = [os.path.join(world["lat_dir"], f"latent_{ts}.npy") for ts in INITS]
    assert [t_ens.init_time_from_filename(f) for f in files] == INITS
    for crop in (True, False):
        assert (t_ens.derive_lead_budget(files, crop, 24)
                == j_ens.derive_lead_budget(files, crop, 24) == (48 if crop else 72))
    for start, end, lead in ((None, None, None), ("2018-01-02", None, None),
                             (None, "2018-01-04", 48), ("2018-01-01", "2018-01-03T12", 24)):
        assert (t_ens.filter_latent_files(files, start, end, lead)
                == j_ens.filter_latent_files(files, start, end, lead))
    for r, n in ((0, 2), (1, 0)):
        np.save(tmp_path / f"crps.rank{r}.npy", np.ones((n, 3, 2), np.float32) * r)
    got = t_ens.merge_rank_shards(str(tmp_path), ["crps"], 2)
    np.testing.assert_array_equal(got["crps"], np.zeros((2, 3, 2)))


def test_cli_refusals(world, tmp_path, monkeypatch):
    import sys

    base = ["--latent_dir", world["lat_dir"], "--truth", world["era5"],
            "--dcae_params", world["dcae_dir"], "--output_dir", str(tmp_path),
            "--allow_truth_mean_climatology", "--device", "cpu"]
    # the plot needs matplotlib, checked before anything is loaded; a zarr
    # truth needs xarray
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(SystemExit, match="matplotlib"):
            t_ens.main(base + ["--plot_diagnostics", "p.png", "--diagnostics"])
    monkeypatch.setitem(sys.modules, "xarray", None)
    # --shard_ensemble runs: in one process it scores as a run without it
    daily = ["--step_size_hour", "24"]
    plain = t_ens.main(base + daily)
    sharded = t_ens.main([a if a != str(tmp_path) else str(tmp_path / "sharded")
                          for a in base] + daily + ["--shard_ensemble"])
    assert sharded["summary"] == plain["summary"]
    for k in t_ens.METRIC_KEYS:
        np.testing.assert_array_equal(np.load(tmp_path / "sharded" / f"{k}.npy"),
                                      np.load(tmp_path / f"{k}.npy"))
    zarr = [a if a != world["era5"] else str(tmp_path / "era5.zarr") for a in base]
    with pytest.raises(ImportError, match="xarray"):
        t_ens.main(zarr)
    with pytest.raises(SystemExit):  # no climatology and no substitute
        t_ens.main([a for a in base if a != "--allow_truth_mean_climatology"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_ens.main(base[:-2])
