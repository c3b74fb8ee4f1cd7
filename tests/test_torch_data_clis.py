"""The port's data CLIs against the JAX package's, in fp32 on the CPU:
``compute_stats``, ``compute_climatology``, ``encode_latents`` and
``evaluate_dcae`` on the same ``.npz`` bundles, with a tiny DCAE at the
real 120 x 240 grid (the statics' grid)."""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladcast_torch.cli import compute_climatology as t_clim
from ladcast_torch.cli import compute_stats as t_stats
from ladcast_torch.cli import encode_latents as t_enc
from ladcast_torch.cli import evaluate_dcae as t_evd
from ladcast_torch.cli import pred_rollout as t_pred
from ladcast_torch.data import time_utils as t_time
from ladcast_tpu import config as j_config
from ladcast_tpu import static_data as j_static
from ladcast_tpu.cli import compute_climatology as j_clim
from ladcast_tpu.cli import compute_stats as j_stats
from ladcast_tpu.cli import encode_latents as j_enc
from ladcast_tpu.cli import evaluate_dcae as j_evd
from ladcast_tpu.data import era5_tar as j_tar
from ladcast_tpu.data import time_utils as j_time
from ladcast_tpu.models import hub as j_hub
from ladcast_tpu.models.dcae import AutoencoderDC as JaxAE

TINY_DCAE = dict(in_channels=89, out_channels=89, latent_channels=8,
                 attention_head_dim=4,
                 encoder_block_types=("ResBlock", "ResBlock"),
                 decoder_block_types=("ResBlock", "ResBlock"),
                 encoder_block_out_channels=(8, 16),
                 decoder_block_out_channels=(8, 16),
                 encoder_layers_per_block=(1, 1), decoder_layers_per_block=(1, 1),
                 encoder_qkv_multiscales=((), ()), decoder_qkv_multiscales=((), ()),
                 static_channels=5)
STAMPS = [2017123112, 2017123118, 2018010100, 2018010106, 2018010112]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The test suite runs files in parallel workers on a shared CPU; two
    intra-op threads per worker keep them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data")
    fm, fs = j_static.era5_mean_std()
    rng = np.random.RandomState(0)
    fields = (rng.randn(len(STAMPS), 120, 240, 84) * fs + fm).astype(np.float32)
    fields[:, 30:60, 100:160, 82] = np.nan  # SST over land
    era5 = str(tmp / "era5.npz")
    np.savez(era5, fields=fields, timestamps=np.asarray(STAMPS, np.int64))
    cfg = j_config.DCAEConfig(**TINY_DCAE)
    params = jax.jit(JaxAE(cfg).init)(jax.random.PRNGKey(3), jnp.zeros((1, 120, 240, 84)),
                             jnp.zeros((120, 240, 5)))
    dcae_dir = str(tmp / "dcae")
    j_hub.save_pretrained(dcae_dir, "dcae", cfg, params)
    return dict(tmp=tmp, era5=era5, fields=fields, dcae_dir=dcae_dir)


def test_compute_stats_matches_jax(world, tmp_path):
    outs = {}
    for name, cli in (("jax", j_stats), ("torch", t_stats)):
        outs[name] = tmp_path / f"{name}.json"
        cli.main(["--data", world["era5"], "--output", str(outs[name]),
                  "--start_year", "2018", "--end_year", "2018", "--batch_size", "2"])
    a, b = (json.loads(outs[k].read_text()) for k in ("jax", "torch"))
    assert a.keys() == b.keys()
    for var in a:
        for k in ("mean", "std"):
            x, y = a[var][k], b[var][k]
            if isinstance(x, dict):
                assert x.keys() == y.keys()
                x, y = list(x.values()), list(y.values())
            np.testing.assert_allclose(y, x, rtol=1e-5)
    # 2018 only, SST over the ocean only
    sst = b["sea_surface_temperature"]["mean"]
    np.testing.assert_allclose(sst, np.nanmean(world["fields"][2:, ..., 82]), rtol=1e-5)


def test_compute_climatology_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    stamps = [2016022818, 2016022900, 2016022906, 2017010100, 2017010106,
              2018010100, 2018010112]
    fields = rng.randn(len(stamps), 4, 6, 84).astype(np.float32)
    fields[:, 0, 0, 82] = np.nan  # land: the bin's mean is NaN
    src = tmp_path / "f.npz"
    np.savez(src, fields=fields, timestamps=np.asarray(stamps, np.int64))
    for extra in ([], ["--start_year", "2017", "--hours", "0,12"]):
        outs = {}
        for name, cli in (("jax", j_clim), ("torch", t_clim)):
            outs[name] = tmp_path / f"{name}.npz"
            cli.main(["--data", str(src), "--output", str(outs[name]), "--batch", "3",
                      *extra])
        with np.load(outs["jax"]) as a, np.load(outs["torch"]) as b:
            np.testing.assert_array_equal(b["clim"], a["clim"])
            np.testing.assert_array_equal(b["hours"], a["hours"])
    with np.load(outs["torch"]) as b:  # 2017 and 2018 at 00z / 12z
        assert b["clim"].shape == (366, 2, 4, 6, 84)
        np.testing.assert_allclose(b["clim"][0, 0], fields[[3, 5]].mean(0), rtol=1e-6)
        np.testing.assert_array_equal(b["clim"][0, 1], fields[6])


@pytest.mark.parametrize("dates", [(), ("--start_date", "2017-12-31T18",
                                        "--end_date", "2018-01-01T06")])
def test_encode_latents_matches_jax(world, tmp_path, dates):
    outs = {}
    args = ["--data", world["era5"], "--dcae_params", world["dcae_dir"],
            "--batch_size", "2", *dates]
    j_enc.main(args + ["--output", str(tmp_path / "jax.npz")])
    res = t_enc.main(args + ["--output", str(tmp_path / "torch.npz"), "--device", "cpu",
                             "--compute_dtype", "float32"])
    for name in ("jax", "torch"):
        with np.load(tmp_path / f"{name}.npz") as d:
            outs[name] = (d["latents"], d["timestamps"])
    np.testing.assert_array_equal(outs["torch"][1], outs["jax"][1])
    assert outs["torch"][0].shape == (len(outs["jax"][1]), 60, 120, 8)
    assert len(outs["jax"][1]) == (3 if dates else 5)
    assert _rel_max(outs["torch"][0], outs["jax"][0]) <= 1e-5
    assert res["encode_s"] > 0


def test_evaluate_dcae_matches_jax(world, tmp_path):
    rows = {}
    for name, cli, extra in (("jax", j_evd, []), ("torch", t_evd, ["--device", "cpu"])):
        out = tmp_path / f"{name}.csv"
        cli.main(["--data", world["era5"], "--dcae_params", world["dcae_dir"],
                  "--output_csv", str(out), "--batch_size", "2", "--max_samples", "3",
                  *extra])
        rows[name] = list(csv.reader(out.open()))
    assert [r[0] for r in rows["torch"]] == [r[0] for r in rows["jax"]]
    assert rows["torch"][0] == ["channel", "lat_weighted_rmse"] and len(rows["jax"]) == 86
    for a, b in zip(rows["jax"][1:], rows["torch"][1:]):
        assert abs(float(b[1]) - float(a[1])) <= 1e-5 * abs(float(a[1])), a[0]


def test_shared_pieces_match_jax():
    for start, end, lead in ((None, None, 0), ("2018-01-02", "2018-03-01T12", 0),
                             (None, "2018-03-01", 240)):
        assert (t_time.date_bounds(start, end, lead)
                == j_time.date_bounds(start, end, lead))
    ts = [1979010100, 2017123118, 2018060100, 2022010100, 2019050500]
    for split in ("train", "validation", "test", "full", "2019"):
        np.testing.assert_array_equal(t_time.split_timestamps(ts, split),
                                      j_tar.split_timestamps(ts, split))


def test_cli_refusals(world, tmp_path):
    with pytest.raises(NotImplementedError, match="M13"):
        t_enc.main(["--data", world["era5"], "--dcae_params", world["dcae_dir"],
                    "--output", str(tmp_path / "lat.zarr"), "--device", "cpu"])
    for cli, extra in ((t_stats, ["--output", str(tmp_path / "s.json")]),
                       (t_clim, ["--output", str(tmp_path / "c.npz")])):
        with pytest.raises(NotImplementedError, match="M13"):
            cli.main(["--data", str(tmp_path / "era5.zarr"), *extra])
    with pytest.raises(NotImplementedError, match="M13"):
        t_pred.open_field_source(str(tmp_path / "tars"))
    if not torch.cuda.is_available():
        for cli, extra in ((t_enc, ["--output", str(tmp_path / "l.npz")]),
                           (t_evd, ["--output_csv", str(tmp_path / "r.csv")])):
            with pytest.raises(RuntimeError, match="CUDA"):
                cli.main(["--data", world["era5"], "--dcae_params",
                          world["dcae_dir"], *extra])
