"""The port's forecast path against the JAX package, in fp32 on the CPU:
the safetensors reader and writer, hub directories both ways, the
``ForecastPipeline`` stage by stage, and ``cli.pred_rollout`` end to end
(file layouts, physical scale, seeding, the flags that wait), with tiny
84-channel models on the real 120 x 240 grid and normalization files."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladcast_torch import config as t_config
from ladcast_torch import static_data as t_static
from ladcast_torch.cli import pred_rollout as t_cli
from ladcast_torch.cli import train_ar as t_train_cli
from ladcast_torch.data import time_utils as t_time
from ladcast_torch.data import transforms as t_transforms
from ladcast_torch.evaluate import export as t_export
from ladcast_torch.models import hub as t_hub
from ladcast_torch.models import safetensors_io
from ladcast_torch.models.weight_import import state_dict_from_flax
from ladcast_torch.rollout.engine import stream_seed
from ladcast_torch.rollout.pipeline import ForecastPipeline as TorchPipeline
from ladcast_tpu import config as j_config
from ladcast_tpu import static_data as j_static
from ladcast_tpu.data import time_utils as j_time
from ladcast_tpu.data import transforms as j_transforms
from ladcast_tpu.evaluate import export as j_export
from ladcast_tpu.models import hub as j_hub
from ladcast_tpu.models.dcae import AutoencoderDC as JaxAE
from ladcast_tpu.models.ladcast_dit import LaDCastTransformer3D as JaxDiT
from ladcast_tpu.rollout.engine import ensemble_rollout as j_ensemble_rollout
from ladcast_tpu.rollout.pipeline import ForecastPipeline as JaxPipeline

DIT_KW = dict(in_channels=84, out_channels=84, num_attention_heads=2,
              attention_head_dim=16, num_layers=1, num_single_layers=1,
              num_refiner_layers=1, mlp_ratio=2.0, rope_axes_dim=(4, 6, 6),
              conditioning_tensor_rope_axes_dim=(4, 6, 6),
              conditioning_tensor_in_channels=84)
# widths are multiples of 4 whose shortcut groups divide down to the
# 84-channel latent
DCAE_KW = dict(in_channels=89, out_channels=89, latent_channels=84,
               attention_head_dim=4,
               encoder_block_out_channels=(84, 84, 84, 84),
               decoder_block_out_channels=(84, 84, 84, 84),
               encoder_layers_per_block=(1, 1, 1, 1),
               decoder_layers_per_block=(1, 1, 1, 1), static_channels=5)
ROLLOUT_KW = dict(ensemble_size=2, num_inference_steps=2, return_seq_len=2,
                  input_seq_len=1, total_lead_time_hour=12, step_size_hour=6)
TS = [2018010100, 2018010106, 2018010112]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --------------------------------------------------------- small parts ----

def test_safetensors_io_matches_the_package(tmp_path):
    np_st = pytest.importorskip("safetensors.numpy")
    torch_st = pytest.importorskip("safetensors.torch")
    rng = np.random.RandomState(0)
    arrays = {"w.f32": rng.randn(3, 5).astype(np.float32),
              "w.f16": rng.randn(4).astype(np.float16),
              "idx": np.arange(6, dtype=np.int64).reshape(2, 3),
              "scalar": np.asarray(2.5, np.float32)}
    theirs, ours = str(tmp_path / "a.safetensors"), str(tmp_path / "b.safetensors")
    np_st.save_file(arrays, theirs)
    got = safetensors_io.load_file(theirs)
    assert set(got) == set(arrays)
    for k, a in arrays.items():
        assert got[k].numpy().dtype == a.dtype
        np.testing.assert_array_equal(got[k].numpy(), a)
    safetensors_io.save_file(got, ours, metadata={"format": "pt"})
    back = np_st.load_file(ours)
    for k, a in arrays.items():
        np.testing.assert_array_equal(back[k], a)
    # bf16, which numpy lacks, against the package's torch reader and writer
    tensors = {"b": torch.randn(7, 3).bfloat16(), "f": torch.randn(2)}
    safetensors_io.save_file(tensors, ours)
    back = torch_st.load_file(ours)
    torch_st.save_file(tensors, theirs)
    got = safetensors_io.load_file(theirs)
    for k, t in tensors.items():
        assert back[k].dtype == got[k].dtype == t.dtype
        assert torch.equal(back[k], t) and torch.equal(got[k], t)
    # a truncated file is refused, not read as garbage
    blob = open(ours, "rb").read()
    open(ours, "wb").write(blob[:-4])
    with pytest.raises(ValueError, match="offsets"):
        safetensors_io.load_file(ours)


def test_transforms_time_utils_static_and_export_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 6, 84).astype(np.float32)
    x[0, :2, :3, 82] = np.nan
    mean, std = rng.randn(84).astype(np.float32), rng.rand(84).astype(np.float32) + 0.5
    tx, tm, ts_ = torch.from_numpy(x), torch.from_numpy(mean), torch.from_numpy(std)
    n_t = t_transforms.normalize(tx, tm, ts_, 0.5)
    np.testing.assert_allclose(n_t.numpy(), j_transforms.normalize(x, mean, std, 0.5),
                               rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(
        t_transforms.inverse_normalize(n_t, tm, ts_, 0.5).numpy(), x, rtol=1e-5,
        atol=1e-6, equal_nan=True)
    masked, nan_mask = t_transforms.mask_sst_nans(tx, 82)
    j_masked, j_mask = j_transforms.mask_sst_nans(jnp.asarray(x), 82)
    np.testing.assert_array_equal(masked.numpy(), np.asarray(j_masked))
    np.testing.assert_array_equal(nan_mask.numpy(), np.asarray(j_mask))
    assert torch.isnan(tx[0, 0, 0, 82])  # the input is left as it was

    np.testing.assert_array_equal(t_time.rollout_year_progress(2018123112, 5, 24),
                                  j_time.rollout_year_progress(2018123112, 5, 24))
    assert t_time.filter_eval_timestamps([2018, 2020], 3) == \
        j_time.filter_eval_timestamps([2018, 2020], 3)
    for s in ("2018-02-03", "2018-02-03T12"):
        assert t_time.date_str_to_int(s) == j_time.date_str_to_int(s)
    with pytest.raises(ValueError):
        t_time.date_str_to_int("2018-02")
    assert t_time.filter_eval_timestamps_range(2018011500, 2018030212, 4) == \
        j_time.filter_eval_timestamps_range(2018011500, 2018030212, 4)

    for a, b in zip(t_static.era5_mean_std(), j_static.era5_mean_std()):
        np.testing.assert_array_equal(a, b)
    for layout in ("CHW", "HWC"):
        np.testing.assert_array_equal(
            t_static.static_conditioning_tensor(layout),
            j_static.static_conditioning_tensor(layout=layout))

    assert t_export.grid_coords(3, 6) == j_export.grid_coords(3, 6)
    dec = rng.randn(2, 3, 4, 5, 84).astype(np.float32)
    t_export.decoded_to_npz(dec, 2018010100, str(tmp_path / "t.npz"))
    j_export.decoded_to_npz(dec, 2018010100, str(tmp_path / "j.npz"))
    a, b = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    np.testing.assert_array_equal(a["fields"], b["fields"])
    assert json.loads(str(a["meta"])) == json.loads(str(b["meta"]))


def test_hub_config_round_trip_and_refusals(tmp_path):
    for kind, cfg in (("dit", t_config.LaDCastDiTConfig(**DIT_KW)),
                      ("dcae", t_config.DCAEConfig(**DCAE_KW))):
        raw = json.loads(json.dumps(t_hub.config_to_dict(kind, cfg)))
        assert t_hub.parse_config_dict(raw) == (kind, cfg)
        # EMA metadata and private keys are not model config
        assert t_hub.parse_config_dict({**raw, "decay": 0.99, "_v": 1}) == (kind, cfg)
        with pytest.raises(ValueError, match="not supported"):
            t_hub.parse_config_dict({**raw, "new_option": 1})
    # the JAX package's names of the attention implementations
    raw = j_hub.config_to_dict("dit", j_config.LaDCastDiTConfig(
        **DIT_KW, attention_impl="xla"))
    assert t_hub.parse_config_dict(raw)[1].attention_impl == "plain"
    with pytest.raises(ValueError, match="_class_name"):
        t_hub.parse_config_dict({"_class_name": "UNet"})
    assert not t_hub.is_hub_dir(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        t_hub.resolve_model_dir(str(tmp_path))
    for sub in ("ar_model", "ar_model_ema"):
        os.makedirs(tmp_path / "ck" / sub)
        (tmp_path / "ck" / sub / "config.json").write_text("{}")
    assert t_hub.is_hub_dir(str(tmp_path / "ck"))
    assert t_hub.resolve_model_dir(str(tmp_path / "ck")).endswith("ar_model_ema")
    assert t_hub.resolve_model_dir(str(tmp_path / "ck"), "ar_model").endswith("ar_model")


# ------------------------------------------------- tiny 84-channel models --

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX tiny models written by the JAX hub (the DiT index-sharded, the
    DCAE as one file), synthetic raw fields with SST NaNs, and both
    packages' fp32 pipelines loaded from those directories."""
    tmp = tmp_path_factory.mktemp("forecast")
    j_dit_cfg = j_config.LaDCastDiTConfig(**DIT_KW, attention_impl="xla")
    j_dcae_cfg = j_config.DCAEConfig(**DCAE_KW)
    dit_params = JaxDiT(j_dit_cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 2, 3, 6, 84)), jnp.zeros((1,)),
        jnp.zeros((1, 1, 3, 6, 84)), jnp.zeros((1,)))
    dcae_params = JaxAE(j_dcae_cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 32, 84)), jnp.zeros((16, 32, 5)))
    dit_dir, dcae_dir = str(tmp / "dit"), str(tmp / "dcae")
    j_hub.save_pretrained(dit_dir, "dit", j_dit_cfg, dit_params,
                          max_shard_bytes=200_000)
    j_hub.save_pretrained(dcae_dir, "dcae", j_dcae_cfg, dcae_params)
    assert os.path.isfile(os.path.join(dit_dir, t_hub.INDEX_NAME))
    assert os.path.isfile(os.path.join(dcae_dir, t_hub.SAFETENSORS_NAME))

    fm, fs = j_static.era5_mean_std()
    rng = np.random.RandomState(0)
    fields = (rng.randn(3, 120, 240, 84) * fs + fm).astype(np.float32)
    fields[:, :40, :40, 82] = np.nan  # SST over land
    era5 = str(tmp / "era5.npz")
    np.savez(era5, fields=fields, timestamps=np.asarray(TS, np.int64))
    norm = j_transforms.normalize(fields, fm, fs)
    norm = np.where(np.isnan(norm), -2.0, norm).astype(np.float32)

    jd, jc = j_hub.load_pretrained(dit_dir), j_hub.load_pretrained(dcae_dir)
    j_pipe = JaxPipeline(jd.config, jc.config, j_config.EDMSchedulerConfig(),
                         j_config.RolloutConfig(**ROLLOUT_KW), jd.params,
                         jc.params, compute_dtype="float32")
    td = t_hub.load_pretrained(dit_dir, expect_kind="dit")
    tc = t_hub.load_pretrained(dcae_dir, expect_kind="dcae")
    t_pipe = TorchPipeline(td.config, tc.config, t_config.EDMSchedulerConfig(),
                           t_config.RolloutConfig(**ROLLOUT_KW), td.params,
                           tc.params, compute_dtype="float32", device="cpu")
    return dict(tmp=tmp, dit_dir=dit_dir, dcae_dir=dcae_dir, era5=era5,
                norm=norm, j_pipe=j_pipe, t_pipe=t_pipe,
                dit_params=dit_params, dcae_params=dcae_params)


def test_hub_directories_written_by_jax_load_in_the_port(world):
    """Sharded and single: the loaded state dicts are the flax trees'
    export, bit for bit, under the module's own names."""
    with pytest.raises(ValueError, match="expected dcae"):
        t_hub.load_pretrained(world["dit_dir"], expect_kind="dcae")
    for kind, d, params in (("dit", world["dit_dir"], world["dit_params"]),
                            ("dcae", world["dcae_dir"], world["dcae_params"])):
        loaded = t_hub.load_pretrained(d)
        assert loaded.kind == kind
        want = state_dict_from_flax(jax.tree.map(np.asarray, params), kind)
        assert set(loaded.params) == set(want)
        for name, w in want.items():
            assert torch.equal(loaded.params[name], w), name
        model = t_hub.build_model(kind, loaded.config, loaded.params, "cpu")
        assert set(model.state_dict()) == set(want) and not model.training
    assert world["t_pipe"].dit_cfg.attention_impl == "plain"


def test_hub_directories_written_by_the_port_load_in_jax(world, tmp_path):
    """The port's writer (one file, and index-sharded) through the JAX
    loader: the same outputs from the same inputs."""
    t_pipe, j_pipe = world["t_pipe"], world["j_pipe"]
    dit_dir, dcae_dir = str(tmp_path / "dit"), str(tmp_path / "dcae")
    t_hub.save_pretrained(dit_dir, "dit", t_pipe.dit_cfg, t_pipe.dit.state_dict())
    t_hub.save_pretrained(dcae_dir, "dcae", t_pipe.dcae_cfg,
                          t_pipe.dcae.state_dict(), max_shard_bytes=150_000,
                          ema_metadata={"decay": 0.999, "junk": 1})
    assert os.path.isfile(os.path.join(dit_dir, t_hub.SAFETENSORS_NAME))
    index = json.load(open(os.path.join(dcae_dir, t_hub.INDEX_NAME)))
    assert len(set(index["weight_map"].values())) > 1
    raw = json.load(open(os.path.join(dcae_dir, "config.json")))
    assert raw["decay"] == 0.999 and "junk" not in raw
    jd, jc = j_hub.load_pretrained(dit_dir), j_hub.load_pretrained(dcae_dir)
    assert jc.config == j_pipe.dcae_cfg
    # the converters are exact transposes: the JAX loader's trees, exported
    # again, are the port's state dicts bit for bit
    for loaded, module in ((jd, t_pipe.dit), (jc, t_pipe.dcae)):
        again = state_dict_from_flax(jax.tree.map(np.asarray, loaded.params),
                                     loaded.kind)
        assert set(again) == set(module.state_dict())
        for name, w in module.state_dict().items():
            assert torch.equal(again[name], w), name
    rng = np.random.RandomState(3)
    z = rng.randn(2, 2, 4, 84).astype(np.float32)  # a small grid: 16 x 32
    want = t_pipe.dcae.decode(torch.from_numpy(z)).detach().numpy()
    got = JaxAE(jc.config).apply(jc.params, jnp.asarray(z), method=JaxAE.decode)
    assert _rel(got, want) <= 1e-4
    lat, cond = (rng.randn(2, t, 3, 6, 84).astype(np.float32) for t in (2, 1))
    cn, yp = rng.randn(2).astype(np.float32), rng.rand(2).astype(np.float32)
    with torch.no_grad():
        want = t_pipe.dit(*(torch.from_numpy(a) for a in (lat, cn, cond, yp))).numpy()
    got = JaxDiT(jd.config).apply(jd.params, *(jnp.asarray(a) for a in
                                               (lat, cn, cond, yp)))
    assert _rel(got, want) <= 1e-4
    # and back into the port: what was written is what is read
    back = t_hub.load_pretrained(dcae_dir)
    for name, w in t_pipe.dcae.state_dict().items():
        assert torch.equal(back.params[name], w), name


def test_pipeline_stages_match_jax(world):
    """encode_fields, the rollout with injected noise, decode_latents in
    physical units with a chunk that does not divide the frame count, and
    forecast_from_fields as their composition; relative L2 <= 1e-4 per
    stage in fp32."""
    t_pipe, j_pipe, norm = world["t_pipe"], world["j_pipe"], world["norm"]
    z_j = np.asarray(j_pipe.encode_fields(jnp.asarray(norm[:2])))
    z_t = t_pipe.encode_fields(torch.from_numpy(norm[:2]))
    assert z_t.shape == (2, 15, 30, 84) and z_t.dtype == torch.float32
    assert _rel(z_t.numpy(), z_j) <= 1e-4
    zn_j = np.asarray(j_pipe.normalize_latent(jnp.asarray(z_j)))
    np.testing.assert_allclose(t_pipe.normalize_latent(torch.tensor(z_j)).numpy(),
                               zn_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        t_pipe.unnormalize_latent(torch.tensor(zn_j)).numpy(), z_j,
        rtol=1e-4, atol=1e-3)

    rng = np.random.RandomState(4)
    rcfg = j_pipe.rollout_cfg
    rep_noise = rng.randn(1, 2, 2, 15, 30, 84).astype(np.float32)
    known = np.broadcast_to(zn_j[None, :1], (2, 1, 15, 30, 84)).copy()
    yp = j_time.rollout_year_progress(TS[0], 1, 12)
    traj_j = np.asarray(j_ensemble_rollout(
        lambda *a: j_pipe.dit.apply(j_pipe.dit_params, *a), jnp.asarray(known),
        jnp.asarray(yp), jax.random.PRNGKey(0), j_pipe.sched_cfg, rcfg,
        rep_noise=jnp.asarray(rep_noise)))
    traj_t = t_pipe.forecast_latents(torch.from_numpy(known), yp, 0,
                                     rep_noise=torch.from_numpy(rep_noise))
    assert traj_t.shape == traj_j.shape == (2, 2, 15, 30, 84)
    assert _rel(traj_t.numpy(), traj_j) <= 1e-4

    dec_j = np.asarray(j_pipe.decode_latents(jnp.asarray(traj_j), 3))
    dec_t = t_pipe.decode_latents(torch.from_numpy(traj_j), chunk=3)  # 4 frames
    assert dec_t.shape == dec_j.shape == (2, 2, 120, 240, 84)
    assert _rel(dec_t.numpy(), dec_j) <= 1e-4
    # physical units: geopotential at 500 hPa is O(5e4) m^2/s^2
    assert abs(float(dec_t[..., 7].mean())) > 1e3
    np.testing.assert_allclose(
        t_pipe.decode_latents(torch.from_numpy(traj_j[:, :1])).numpy(),
        dec_t[:, :1].numpy(), rtol=1e-5, atol=1e-2)

    traj, decoded, z_an = t_pipe.forecast_from_fields(
        torch.from_numpy(norm[:1]), TS[0], 0, rep_noise=torch.from_numpy(rep_noise))
    assert _rel(z_an.numpy(), z_j[:1]) <= 1e-4
    assert _rel(traj.numpy(), traj_j) <= 1e-4
    assert _rel(decoded.numpy(), dec_j) <= 1e-4
    assert t_pipe.forecast_from_fields(torch.from_numpy(norm[:1]), TS[0], 0,
                                       decode=False)[1] is None


def test_pipeline_host_step_gives_the_same_trajectory(world):
    t_pipe = world["t_pipe"]
    known = torch.randn(2, 1, 15, 30, 84, generator=torch.Generator().manual_seed(1))
    a = t_pipe.forecast_latents(known, [0.3], 9)
    t_pipe.host_step = True
    try:
        b = t_pipe.forecast_latents(known, [0.3], 9)
    finally:
        t_pipe.host_step = False
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a[0], a[1])


def _cli_args(world, out, *extra):
    return t_cli.build_parser().parse_args([
        "--data", world["era5"], "--dit_params", world["dit_dir"],
        "--dcae_params", world["dcae_dir"], "--output_dir", out,
        "--year", "2018", "--num_samples_per_month", "1",
        "--ensemble_size", "2", "--num_inference_steps", "2",
        "--return_seq_len", "2", "--total_lead_time_hour", "12",
        "--device", "cpu", *extra])


def test_cli_pred_rollout_on_the_cpu(world, tmp_path):
    """The artifacts ``tests/test_cli_chain.py`` pins for the JAX CLI: the
    .npy layout (ens, C, T+1, h, w), channels first, physical latent
    scale, t=0 the raw encoder output; here in fp32 so that the frames
    can be held to the JAX pipeline."""
    t_pipe, j_pipe, norm = world["t_pipe"], world["j_pipe"], world["norm"]
    out = str(tmp_path / "out")
    recs = t_cli.run(_cli_args(world, out, "--decode"), compute_dtype="float32")
    done = [r["init_time"] for r in recs if "rollout_s" in r]
    skipped = [r for r in recs if "skipped" in r]
    assert done == [2018010100, 2018010112] and len(skipped) == 22
    arr = np.load(os.path.join(out, "latent_2018010100.npy"))
    assert arr.shape == (2, 84, 3, 15, 30) and arr.dtype == np.float32
    z_j = np.asarray(j_pipe.encode_fields(jnp.asarray(norm[:1])))
    t0 = np.moveaxis(arr[:, :, 0], 1, -1)
    np.testing.assert_array_equal(t0[0], t0[1])
    assert _rel(t0[0], z_j[0]) <= 1e-4
    # the forecast frames: the pipeline's trajectory for the same stream,
    # unnormalized to the physical latent scale
    traj = t_pipe.forecast_latents(
        t_pipe.normalize_latent(torch.from_numpy(t0[:, None])),
        t_time.rollout_year_progress(2018010100, 1, 12),
        stream_seed(0, 2018010100))
    np.testing.assert_allclose(np.moveaxis(arr[:, :, 1:], 1, -1),
                               t_pipe.unnormalize_latent(traj).numpy(),
                               rtol=1e-5, atol=1e-4)
    bundle = np.load(os.path.join(out, "fields_2018010100.npz"))
    assert bundle["fields"].shape == (2, 2, 120, 240, 84)
    meta = json.loads(str(bundle["meta"]))
    assert meta["init_time"] == 2018010100
    assert meta["prediction_timedelta_hours"] == [6, 12]
    np.testing.assert_allclose(bundle["fields"],
                               t_pipe.decode_latents(traj).numpy(), rtol=1e-5,
                               atol=1e-3)

    # the same seed and init time give the same file, whatever else the run
    # holds; another seed gives another ensemble
    again, other = str(tmp_path / "again"), str(tmp_path / "other")
    t_cli.run(_cli_args(world, again, "--start_date", "2018-01-01T12",
                        "--end_date", "2018-01-01T12", "--host_step"),
              compute_dtype="float32")
    assert sorted(os.listdir(again)) == ["latent_2018010100.npy",
                                         "latent_2018010112.npy"]
    t_cli.run(_cli_args(world, other, "--seed", "1"), compute_dtype="float32")
    for ts in (2018010100, 2018010112):
        a, b, c = (np.load(os.path.join(d, f"latent_{ts}.npy"))
                   for d in (out, again, other))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a[:, :, 0], c[:, :, 0])
        assert not np.array_equal(a[:, :, 1:], c[:, :, 1:])

    # the DPM sampler, in the default bf16, through main()
    dpm = str(tmp_path / "dpm")
    t_cli.main(["--data", world["era5"], "--dit_params", world["dit_dir"],
                "--dcae_params", world["dcae_dir"], "--output_dir", dpm,
                "--start_date", "2018-01-01", "--end_date", "2018-01-01",
                "--num_samples_per_month", "1", "--ensemble_size", "2",
                "--num_inference_steps", "3", "--return_seq_len", "2",
                "--total_lead_time_hour", "6", "--sampler", "dpm",
                "--device", "cpu"])
    arr = np.load(os.path.join(dpm, "latent_2018010100.npy"))
    assert arr.shape == (2, 84, 2, 15, 30) and np.isfinite(arr).all()
    assert _rel(np.moveaxis(arr[0, :, 0], 0, -1), z_j[0]) <= 3e-2  # bf16 DCAE


def test_cli_flags_that_wait_raise(world, tmp_path):
    """Only zarr data waits now; --shard_ensemble runs, and in one process
    (one rank holds every member) writes the files of a run without it."""
    out = str(tmp_path / "x")
    plain, sharded = str(tmp_path / "plain"), str(tmp_path / "sharded")
    t_cli.run(_cli_args(world, plain), compute_dtype="float32")
    t_cli.run(_cli_args(world, sharded, "--shard_ensemble"), compute_dtype="float32")
    names = sorted(os.listdir(plain))
    assert names == sorted(os.listdir(sharded)) and len(names) == 2
    for name in names:
        np.testing.assert_array_equal(np.load(os.path.join(sharded, name)),
                                      np.load(os.path.join(plain, name)))
    args = _cli_args(world, out)
    args.data = str(tmp_path / "era5.zarr")
    with pytest.raises(NotImplementedError, match="M13"):
        t_cli.run(args)
    with pytest.raises(ValueError, match="together"):
        t_cli.run(_cli_args(world, out, "--start_date", "2018-01-01"))
    with pytest.raises(SystemExit):
        t_cli.main(["--data", "d.npz", "--dit_params", "a", "--dcae_params", "b",
                    "--output_dir", out, "--end_date", "2018-01-02"])
    args = _cli_args(world, out)
    args.dit_params = str(tmp_path / "nothing")
    with pytest.raises(FileNotFoundError):
        t_cli.run(args)
    if not torch.cuda.is_available():
        args = _cli_args(world, out)
        args.device = "cuda"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_cli.run(args)


TINY_AR_CFG = {
    "ar_model": {k: list(v) if isinstance(v, tuple) else v
                 for k, v in DIT_KW.items()},
    "general": {"checkpointing_steps": 2, "checkpoints_total_limit": 2},
    "train_dataloader": {"batch_size": 2, "input_seq_len": 1, "return_seq_len": 2},
    "lr_scheduler": {"num_warmup_steps": 1},
    "ema": {"ema_update_after_step": 0},
}


def test_trainer_export_is_loaded_by_pred_rollout(world, tmp_path, monkeypatch):
    """``train_ar --hub_export`` writes ar_model/ and ar_model_ema/; the
    forecast CLI loads the export (the EMA weights by preference), the
    trainer's own checkpoint directory and a bare .safetensors file, and
    ``--init_weights`` warm-starts a new run from the export."""
    rng = np.random.RandomState(8)
    latents = str(tmp_path / "latents.npz")
    np.savez(latents, latents=rng.randn(24, 3, 6, 84).astype(np.float32),
             timestamps=np.asarray([t_time.add_hours_int(2018010100, i)
                                    for i in range(24)], np.int64))
    run_dir = str(tmp_path / "run")
    argv = ["--latents", latents, "--output_dir", run_dir, "--device", "cpu",
            "--log_every", "1", "--compute_dtype", "float32"]
    parser = t_train_cli.build_parser()
    res = t_train_cli.run(TINY_AR_CFG, parser.parse_args(
        argv + ["--num_steps", "2", "--hub_export"]))
    state = res["state"]
    hub_dir = os.path.join(run_dir, "hub")
    assert sorted(os.listdir(hub_dir)) == ["ar_model", "ar_model_ema"]
    ema_raw = json.load(open(os.path.join(hub_dir, "ar_model_ema", "config.json")))
    assert ema_raw["optimization_step"] == 2 and ema_raw["update_after_step"] == 0
    raw = t_hub.load_pretrained(hub_dir, "ar_model")
    ema = t_hub.load_pretrained(hub_dir)  # ar_model_ema by preference
    names = [n for n, _ in state.model.named_parameters()]
    assert raw.config == ema.config == t_config.LaDCastDiTConfig(**DIT_KW)
    for name, p, e in zip(names, state.model.parameters(), state.ema.params):
        assert torch.equal(raw.params[name], p.detach()), name
        assert torch.equal(ema.params[name], e), name
    assert any(not torch.equal(raw.params[n], ema.params[n]) for n in names)

    bare = str(tmp_path / "ema.safetensors")
    safetensors_io.save_file(ema.params, bare)
    # the bare file and the trainer's directory hold no config.json: the
    # CLI takes its --model config, here the tiny one
    monkeypatch.setattr(t_cli, "ladcast_375m_config", lambda: ema.config)
    outs = {}
    for label, dit_params in (("hub", hub_dir), ("bare", bare),
                              ("ckpts", os.path.join(run_dir, "ckpts"))):
        out = str(tmp_path / label)
        args = _cli_args(world, out, "--start_date", "2018-01-01",
                         "--end_date", "2018-01-01")
        args.dit_params = dit_params
        t_cli.run(args, compute_dtype="float32")
        outs[label] = np.load(os.path.join(out, "latent_2018010100.npy"))
        assert np.isfinite(outs[label]).all()
    np.testing.assert_array_equal(outs["hub"], outs["bare"])
    np.testing.assert_array_equal(outs["hub"], outs["ckpts"])

    warm = t_train_cli.run(TINY_AR_CFG, parser.parse_args(
        argv[:2] + ["--output_dir", str(tmp_path / "warm"), "--device", "cpu",
                    "--num_steps", "0", "--init_weights", hub_dir]))["state"]
    assert warm.step == 0
    for name, p, e in zip(names, warm.model.parameters(), warm.ema.params):
        assert torch.equal(p.detach(), ema.params[name]) and torch.equal(e, p.detach())
