"""The port's tooling and small public helpers against the JAX package's, on
the CPU: profiling (phases, device traces, the compile report), the WB2
climatology converter and the download CLI, the export and zarr paths
(held to JAX where xarray and zarr are installed; without xarray each fails
naming it), the helpers of channels, config, static_data, time_utils and
edm, and the scaled-up ``dcae_ray_1024`` DCAE at narrow widths."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladcast_torch import channels as t_ch
from ladcast_torch import config as t_config
from ladcast_torch import static_data as t_static
from ladcast_torch.cli import convert_wb2_climatology as t_wb2
from ladcast_torch.cli import download_wb2 as t_dl
from ladcast_torch.cli import pred_rollout as t_pred
from ladcast_torch.data import latent_dataset as t_lat
from ladcast_torch.data import time_utils as t_time
from ladcast_torch.diffusion import edm as t_edm
from ladcast_torch.evaluate import export as t_export
from ladcast_torch.models.dcae import AutoencoderDC as TorchAE
from ladcast_torch.models.weight_import import state_dict_from_flax
from ladcast_torch.ops import flash_attention as t_fa
from ladcast_torch.utils import profiling as t_prof
from ladcast_torch.utils.registry import load_yaml
from ladcast_tpu import channels as j_ch
from ladcast_tpu import config as j_config
from ladcast_tpu import static_data as j_static
from ladcast_tpu.cli import convert_wb2_climatology as j_wb2
from ladcast_tpu.cli import download_wb2 as j_dl
from ladcast_tpu.data import time_utils as j_time
from ladcast_tpu.diffusion import edm as j_edm
from ladcast_tpu.evaluate import export as j_export
from ladcast_tpu.models.dcae import AutoencoderDC as JaxAE
from tests.test_wb2_climatology import FakeArray, FakeDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The test suite runs files in parallel workers on a shared CPU; two
    intra-op threads per worker keep them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- profiling ---------------------------------------------------------------

def test_phase_timer_with_sync():
    timer = t_prof.PhaseTimer()
    for _ in range(2):
        with timer.phase("a", sync=True):
            torch.ones(4).sum()
    with timer.phase("b"):
        pass
    s = timer.summary()
    assert list(s) == ["a", "b"] and s["a"]["count"] == 2 and s["b"]["count"] == 1
    assert s["a"]["total_s"] >= 0 and s["b"]["total_s"] >= 0
    assert all(list(v) == ["total_s", "count"] for v in s.values())
    json.dumps(s)  # what the trainers log


def test_device_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with t_prof.device_trace(str(tmp_path / "trace")) as prof:
        (x @ x).relu_()
    assert any(e.name == "aten::mm" for e in prof.events())
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names and "aten::relu_" in names


def test_compile_report():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    rep = t_prof.compile_report(torch.matmul, a, b)
    assert set(rep) == {"first_call_s", "steady_s", "flops", "kernels",
                        "flops_complete", "uncounted"}
    assert rep["flops"] == 2 * 8 * 16 * 4
    assert rep["flops_complete"] and rep["uncounted"] == {} and rep["kernels"] == {}

    def with_a_kernel(x, y):  # as a wrapper that launched a hand-written kernel
        t_fa.norm_rope.launches += 1
        t_prof.count_kernel("norm_rope", 0)
        t_fa.fused_attention.launches += 1
        t_prof.count_kernel("fused_attention", 1000)
        return x @ y

    def without_its_count(x, y):  # a launch that reports no FLOPs
        t_fa.norm_rope.launches += 1
        return x @ y

    before = (t_fa.norm_rope.launches, t_fa.fused_attention.launches)
    try:
        rep = t_prof.compile_report(with_a_kernel, a, b)
        # the kernels' reports count inside the report's count only
        assert rep["flops"] == 2 * 8 * 16 * 4 + 1000
        assert rep["kernels"] == {"norm_rope": {"launches": 1, "flops": 0},
                                  "fused_attention": {"launches": 1, "flops": 1000}}
        assert rep["flops_complete"] and rep["uncounted"] == {}
        rep = t_prof.compile_report(without_its_count, a, b)
    finally:
        t_fa.norm_rope.launches, t_fa.fused_attention.launches = before
    assert rep["uncounted"] == {"norm_rope": 1} and not rep["flops_complete"]


def test_flop_counts_nest():
    """A kernel's report reaches every open count; counts close in order."""
    with t_prof.FlopCount() as outer:
        t_prof.count_kernel("dense_conv", 10)
        with t_prof.FlopCount() as inner:
            t_prof.count_kernel("dense_conv", 5)
    t_prof.count_kernel("dense_conv", 7)  # no count open: nothing kept
    assert inner.total == 5 and outer.total == 15
    assert outer.kernels == {"dense_conv": {"launches": 2, "flops": 15}}
    # no launch counter moved, so the reports are no launches to account for
    assert outer.uncounted == {} and inner.uncounted == {}


def test_card_peaks():
    """Matched on the card's name, the H100 SXM the default; TF32 at half
    the bf16 rate, int8 at twice it."""
    assert t_prof.card_peaks("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    assert t_prof.card_peaks("NVIDIA H100 PCIe")["bf16"] == 756e12
    for _, p in t_prof.CARD_PEAKS:
        assert p["tf32"] == p["bf16"] / 2
        assert p["int8"] == pytest.approx(2 * p["bf16"], rel=0.001)


# -- the WB2 climatology and the download CLI ------------------------------

def _with(n_doy=366, **arrays):
    ds = FakeDataset(n_doy=n_doy)
    ds._v.update({k: FakeArray(*v) for k, v in arrays.items()})
    return ds


# each case: (the fake WB2 dataset, keyword arguments); built when run
WB2_CASES = {
    "366": lambda: (FakeDataset(), {}),
    "365": lambda: (FakeDataset(n_doy=365), {}),
    "ascending": lambda: (_with(365, latitude=(("latitude",), np.linspace(-88.5, 90.0, 7))),
                          {}),  # no pole row to crop, nothing to flip
    "hours_6": lambda: (FakeDataset(n_doy=2), {"hours": (0, 6), "allow_partial_doy": True}),
    "partial": lambda: (FakeDataset(n_doy=2), {"allow_partial_doy": True}),
    "partial_refused": lambda: (FakeDataset(n_doy=2), {}),
    "not_contiguous": lambda: (_with(2, dayofyear=(("dayofyear",), np.asarray([152, 153]))),
                               {"allow_partial_doy": True}),
    "missing_hour": lambda: (FakeDataset(n_doy=2), {"hours": (0, 6, 12, 17),
                                                    "allow_partial_doy": True}),
    "missing_level": lambda: (_with(2, level=(("level",),
                                              np.asarray(j_ch.PRESSURE_LEVELS[:-1]))),
                              {"allow_partial_doy": True}),
    "missing_dim": lambda: (_with(2, **{"2m_temperature": (
        ("dayofyear", "latitude", "longitude"), np.zeros((2, 7, 8), np.float32))}),
        {"allow_partial_doy": True}),
}


@pytest.mark.parametrize("case", list(WB2_CASES))
def test_wb2_climatology_matches_jax(case):
    ds, kw = WB2_CASES[case]()
    out = {}
    for name, mod in (("torch", t_wb2), ("jax", j_wb2)):
        try:
            out[name] = mod.wb2_climatology_to_arrays(ds, **kw)
        except ValueError as e:
            out[name] = str(e)
    if isinstance(out["jax"], str):
        assert out["torch"] == out["jax"]
        return
    for got, want in zip(out["torch"], out["jax"]):
        np.testing.assert_array_equal(got, want)
    assert out["torch"][0].dtype == np.float32


@pytest.mark.parametrize("cli", ["convert_wb2_climatology", "download_wb2"])
def test_clis_exit_naming_xarray(cli, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "xarray", None)
    argv = (["--input", str(tmp_path / "c.zarr"), "--output", str(tmp_path / "c.npz")]
            if cli == "convert_wb2_climatology" else ["--output", str(tmp_path / "e.zarr")])
    msgs = []
    for mod in {"convert_wb2_climatology": (t_wb2, j_wb2),
                "download_wb2": (t_dl, j_dl)}[cli]:
        with pytest.raises(SystemExit, match="xarray") as e:
            mod.main(argv)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert not os.listdir(tmp_path)
    assert (t_dl.WB2_ERA5_URL, t_dl.SURFACE_VARS, t_dl.STATIC_VARS) == (
        j_dl.WB2_ERA5_URL, j_dl.SURFACE_VARS, j_dl.STATIC_VARS)


# -- export and the zarr paths -------------------------------------------------

def test_pack_variables_matches_jax():
    decoded = np.random.RandomState(0).randn(2, 3, 4, 5, 84).astype(np.float32)
    for extract in (None, ["temperature", "2m_temperature"]):
        got = t_export.pack_variables(decoded, t_ch.ATM_VARIABLES, t_ch.SURFACE_VARIABLES,
                                      t_ch.NUM_LEVELS, extract)
        want = j_export.pack_variables(decoded, j_ch.ATM_VARIABLES, j_ch.SURFACE_VARIABLES,
                                       j_ch.NUM_LEVELS, extract)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert got["temperature"].shape == (2, 3, 13, 4, 5)


def test_zarr_paths_fail_naming_xarray(tmp_path, monkeypatch):
    from ladcast_torch.cli import encode_latents as t_enc
    from ladcast_torch.cli import train_ar as t_train

    monkeypatch.setitem(sys.modules, "xarray", None)
    store = str(tmp_path / "era5.zarr")
    for call in (lambda: t_pred.ZarrFieldSource(store),
                 lambda: t_pred.open_field_source(store),
                 lambda: t_lat.open_zarr_latent_source(store),
                 lambda: t_train.load_latent_source(str(tmp_path)),
                 lambda: t_export.decoded_to_dataset(np.zeros((1, 1, 2, 2, 84)), 2018010100),
                 lambda: t_enc.main(["--data", "absent.npz", "--dcae_params", "absent",
                                     "--output", store, "--device", "cpu"])):
        with pytest.raises(ImportError, match="xarray"):
            call()
    assert not os.path.exists(store)


def _zarr_fields(tmp_path):
    """A small ERA5 zarr in the reference layout (121 latitudes from the
    south pole, 2 longitudes, 3 times)."""
    xr = pytest.importorskip("xarray")
    pytest.importorskip("zarr")
    import pandas as pd

    rng = np.random.RandomState(0)
    times = pd.to_datetime(["2018-01-01T00", "2018-01-01T06", "2018-01-01T12"])
    lat = np.arange(-90.0, 90.0 + 1e-6, 1.5)
    coords = {"time": times, "level": list(j_ch.PRESSURE_LEVELS), "latitude": lat,
              "longitude": [0.0, 1.5]}
    ds = xr.Dataset(coords=coords)
    for v in j_ch.ATM_VARIABLES:
        ds[v] = (("time", "level", "latitude", "longitude"),
                 rng.randn(3, 13, 121, 2).astype(np.float32))
    for v in j_ch.SURFACE_VARIABLES:
        ds[v] = (("time", "latitude", "longitude"), rng.randn(3, 121, 2).astype(np.float32))
    path = str(tmp_path / "era5.zarr")
    ds.to_zarr(path, mode="w")
    return path


def test_zarr_field_source_matches_jax(tmp_path):
    path = _zarr_fields(tmp_path)
    from ladcast_tpu.cli import pred_rollout as j_pred

    t_src, t_ts = t_pred.open_field_source(path)
    j_src, j_ts = j_pred.open_field_source(path)
    np.testing.assert_array_equal(t_ts, j_ts)
    stamps = [2018010112, 2018010100]
    np.testing.assert_array_equal(t_src.frames_at(stamps), j_src.frames_at(stamps))
    assert t_src.frames_at(stamps).shape == (2, 120, 2, 84)


def test_decoded_to_dataset_and_append_match_jax(tmp_path):
    pytest.importorskip("xarray")
    pytest.importorskip("zarr")
    import xarray as xr

    decoded = np.random.RandomState(1).randn(2, 2, 120, 240, 84).astype(np.float32)
    for name, mod in (("torch", t_export), ("jax", j_export)):
        for ts in (2018010100, 2018010112):
            mod.append_to_zarr(mod.decoded_to_dataset(decoded, ts),
                               str(tmp_path / f"{name}.zarr"))
    got, want = (xr.open_zarr(str(tmp_path / f"{n}.zarr")) for n in ("torch", "jax"))
    xr.testing.assert_identical(got.load(), want.load())
    assert got.sizes["time"] == 2


def test_zarr_latents_match_jax(tmp_path):
    pytest.importorskip("xarray")
    pytest.importorskip("zarr")
    import pandas as pd
    import xarray as xr

    from ladcast_tpu.data import latent_dataset as j_lat

    lat = np.random.RandomState(2).randn(4, 84, 3, 5).astype(np.float32)
    times = pd.to_datetime(["2018-01-01T00", "2018-01-01T06", "2018-01-01T12",
                            "2018-01-01T18"])
    xr.DataArray(lat, dims=("time", "C", "H", "W"), coords={"time": times},
                 name="latents").to_dataset().to_zarr(str(tmp_path / "l.zarr"))
    kw = dict(start_date="2018-01-01T06", end_date="2018-01-01T18")
    got = t_lat.open_zarr_latent_source(str(tmp_path / "l.zarr"), **kw)
    want = j_lat.open_zarr_latent_source(str(tmp_path / "l.zarr"), **kw)
    np.testing.assert_array_equal(got.latents, want.latents)
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    assert got.latents.shape == (3, 3, 5, 84)


# -- the small helpers ---------------------------------------------------------

def test_channel_helpers_match_jax():
    assert t_ch.channel_slices() == j_ch.channel_slices()
    for name in ("STATIC_VARIABLES", "NUM_SURFACE_VARS", "NUM_STATIC_CHANNELS",
                 "GRID_LAT", "GRID_LON", "LATENT_LAT", "LATENT_LON",
                 "LATENT_SPATIAL_SCALE", "LATENT_LAT_CENTERS", "SST_SURFACE_INDEX",
                 "SST_CHANNEL_INDEX"):
        assert getattr(t_ch, name) == getattr(j_ch, name), name


def test_static_helpers_match_jax():
    np.testing.assert_array_equal(t_static.latent_lat_centers(),
                                  j_static.latent_lat_centers())
    for name in ("ERA5_normal_1979_2017.json", "ERA5_latent_normal_1979_2017_lat84.json"):
        assert t_static.load_normalization_json(name) == j_static.load_normalization_json(name)
    d = j_static.load_normalization_json()
    names = ["temperature", "2m_temperature", "surface_pressure"]
    for got, want in zip(t_static.precompute_mean_std(d, names),
                         j_static.precompute_mean_std(d, names)):
        np.testing.assert_array_equal(got, want)
    for sp in (False, True):
        for got, want in zip(t_static.era5_mean_std(sp), j_static.era5_mean_std(sp)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="No normalization"):
        t_static.precompute_mean_std(d, ["absent"])


def test_time_and_edm_helpers_match_jax():
    ts = [2018010100, 2018070112, 2020022918, 2019123118]
    np.testing.assert_array_equal(t_time.timestamps_to_year_progress(ts),
                                  j_time.timestamps_to_year_progress(ts))
    sigmas = np.asarray([80.0, 10.0, 1.0, 0.1, 0.002], np.float32)
    np.testing.assert_allclose(
        t_edm.timesteps_from_sigmas(torch.from_numpy(sigmas)).numpy(),
        np.asarray(j_edm.timesteps_from_sigmas(jnp.asarray(sigmas))), rtol=1e-6)


def test_config_helpers_match_jax():
    for t_cfg, j_cfg in ((t_config.dcae_ray_1024_config(), j_config.dcae_ray_1024_config()),
                         (t_config.DCAEConfig(), j_config.DCAEConfig()),
                         (t_config.RolloutConfig(), j_config.RolloutConfig())):
        assert t_config.config_to_json(t_cfg) == j_config.config_to_json(j_cfg)
    assert (t_config.dcae_ray_1024_config(latent_channels=8).latent_channels
            == j_config.dcae_ray_1024_config(latent_channels=8).latent_channels == 8)


def test_ray_yaml_builds_the_jax_config():
    """configs/dcae_ray_1024.yaml, read without PyYAML, gives the fields of
    JAX's ``dcae_ray_1024_config``."""
    enc = load_yaml(os.path.join(ROOT, "configs", "dcae_ray_1024.yaml"))["encdec"]
    got = t_config.config_from_dict(t_config.DCAEConfig, enc)
    assert got == t_config.dcae_ray_1024_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(j_config.dcae_ray_1024_config())


RAY_NARROW = dict(latent_channels=64, encoder_block_out_channels=(32, 64, 64, 128),
                  decoder_block_out_channels=(32, 64, 64, 128),
                  encoder_layers_per_block=(1, 1, 1, 1),
                  decoder_layers_per_block=(1, 1, 1, 1))


def test_ray_dcae_structure_matches_jax():
    """The ray DCAE's structure (90 channels, 6 statics, multiscale 5,
    pixel (un)shuffle) at narrow widths, one layer a block, in fp32, with
    the JAX weights: encode and decode within 1e-4 relative L2."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 16, 32, 84).astype(np.float32)
    static = rng.randn(16, 32, 6).astype(np.float32)
    jmodel = JaxAE(j_config.dcae_ray_1024_config(**RAY_NARROW))
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(static)))
    tmodel = TorchAE(t_config.dcae_ray_1024_config(**RAY_NARROW))
    tmodel.load_state_dict(state_dict_from_flax(params, "dcae"), strict=True)
    tmodel.eval()
    z_j = np.array(jax.jit(lambda p, a, s: jmodel.apply(p, a, s, method=JaxAE.encode))(
        params, jnp.asarray(x), jnp.asarray(static)))
    y_j = np.array(jax.jit(lambda p, z: jmodel.apply(p, z, True, method=JaxAE.decode))(
        params, jnp.asarray(z_j)))
    with torch.no_grad():
        z_t = tmodel.encode(torch.from_numpy(x), torch.from_numpy(static)).numpy()
        y_t = tmodel.decode(torch.from_numpy(z_j), True).numpy()

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert z_t.shape == z_j.shape == (1, 2, 4, 64)
    assert y_t.shape == y_j.shape == (1, 16, 32, 90)
    assert rel(z_t, z_j) <= 1e-4 and rel(y_t, y_j) <= 1e-4, (rel(z_t, z_j), rel(y_t, y_j))
