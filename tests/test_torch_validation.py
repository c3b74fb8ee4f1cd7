"""The port's AR validation (``train.validation.validate_ar_model``)
against the JAX package's with injected sampler noise, in fp32 on the CPU,
latent-only and decoded; and ``cli.train_ar`` with ``--val_every`` and
``--val_latents``, which no longer raises."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import ladcast_tpu.train.validation as j_val
from ladcast_torch import config as t_config
from ladcast_torch import static_data as t_static
from ladcast_torch.cli import train_ar as t_cli
from ladcast_torch.data.time_utils import add_hours_int
from ladcast_torch.metrics.weights import cos_lat_weights
from ladcast_torch.models import hub as t_hub
from ladcast_torch.models.weight_import import state_dict_from_flax
from ladcast_torch.models.ladcast_dit import LaDCastTransformer3D as TorchDiT
from ladcast_torch.train.validation import validate_ar_model
from ladcast_tpu import config as j_config
from ladcast_tpu.models.dcae import AutoencoderDC as JaxAE
from ladcast_tpu.models.ladcast_dit import LaDCastTransformer3D as JaxDiT

DIT_KW = dict(in_channels=84, out_channels=84, num_attention_heads=2,
              attention_head_dim=16, num_layers=1, num_single_layers=1,
              num_refiner_layers=1, mlp_ratio=2.0, rope_axes_dim=(4, 6, 6),
              conditioning_tensor_rope_axes_dim=(4, 6, 6),
              conditioning_tensor_in_channels=84)
# 84-channel latents on the 15 latent rows, decoded 8x to the 120-row grid
DCAE_KW = dict(in_channels=89, out_channels=89, latent_channels=84,
               attention_head_dim=4, encoder_block_types=("ResBlock",) * 4,
               decoder_block_types=("ResBlock",) * 4,
               encoder_qkv_multiscales=((),) * 4, decoder_qkv_multiscales=((),) * 4,
               encoder_block_out_channels=(84, 84, 84, 84),
               decoder_block_out_channels=(84, 84, 84, 84),
               encoder_layers_per_block=(1, 1, 1, 1),
               decoder_layers_per_block=(1, 1, 1, 1), static_channels=5)
ROLLOUT = dict(ensemble_size=2, num_inference_steps=5, return_seq_len=2,
               input_seq_len=1, total_lead_time_hour=18, step_size_hour=6)
H, W = 15, 2


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The test suite runs files in parallel workers on a shared CPU; two
    intra-op threads per worker keep them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def models():
    dit_cfg = j_config.LaDCastDiTConfig(**DIT_KW, attention_impl="xla")
    dit_params = jax.jit(JaxDiT(dit_cfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 2, H, W, 84)), jnp.zeros((1,)),
        jnp.zeros((1, 1, H, W, 84)), jnp.zeros((1,)))
    dcae_cfg = j_config.DCAEConfig(**DCAE_KW)
    dcae_params = jax.jit(JaxAE(dcae_cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8 * H, 8 * W, 84)),
        jnp.zeros((8 * H, 8 * W, 5)))
    dit = TorchDiT(t_config.LaDCastDiTConfig(**DIT_KW))
    dit.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, dit_params),
                                             "dit"), strict=True)
    dcae = t_hub.build_model(
        "dcae", t_config.DCAEConfig(**DCAE_KW),
        state_dict_from_flax(jax.tree.map(np.asarray, dcae_params), "dcae"), "cpu")
    return dict(dit_cfg=dit_cfg, dit_params=dit_params, dcae_cfg=dcae_cfg,
                dcae_params=dcae_params, dit=dit.eval(), dcae=dcae)


@pytest.mark.parametrize("decoded", [False, True])
def test_validate_ar_model_matches_jax(models, monkeypatch, decoded):
    """Init times with their own injected noise (two latent-only, one
    decoded). The JAX validator draws its noise inside one jitted call per
    init time, so it runs once per init time with ``ensemble_rollout``
    given that time's noise."""
    rcfg_j = j_config.RolloutConfig(**ROLLOUT)
    rng = np.random.RandomState(2)
    N, n_steps = 1 if decoded else 2, rcfg_j.total_num_steps  # the last rep overshoots
    vin = rng.randn(N, 1, H, W, 84).astype(np.float32)
    vtg = rng.randn(N, n_steps, H, W, 84).astype(np.float32)
    vyp = rng.rand(N, rcfg_j.num_repetitions).astype(np.float32)
    noise = rng.randn(N, rcfg_j.num_repetitions, 2, 2, H, W, 84).astype(np.float32)
    lm, ls = t_static.latent_mean_std()
    dec = {}
    if decoded:
        stats = dict(latent_stats=(lm, ls), field_stats=t_static.era5_mean_std(),
                     grid_lat_weight=cos_lat_weights(np.linspace(-88.5, 90.0, 8 * H)))
    want = []
    real = j_val.ensemble_rollout
    model = JaxDiT(models["dit_cfg"])
    for i in range(N):
        monkeypatch.setattr(j_val, "ensemble_rollout",
                            lambda *a, _n=noise[i], **k: real(
                                *a, **k, rep_noise=jnp.asarray(_n)))
        if decoded:
            dcae = JaxAE(models["dcae_cfg"])
            dec = dict(decode_fn=lambda p, z: dcae.apply(p, z, method=JaxAE.decode),
                       dcae_params=models["dcae_params"], **stats)
        want.append(j_val.validate_ar_model(
            lambda p, lat, cn, cond, yp: model.apply(p, lat, cn, cond, yp),
            models["dit_params"], jnp.asarray(vin[i:i + 1]), jnp.asarray(vtg[i:i + 1]),
            vyp[i:i + 1], jax.random.PRNGKey(i), j_config.EDMSchedulerConfig(),
            rcfg_j, **dec))
    dit = models["dit"]
    got = validate_ar_model(
        lambda lat, cn, cond, yp: dit(lat, cn, cond, yp), torch.from_numpy(vin),
        torch.from_numpy(vtg), vyp, 0, t_config.EDMSchedulerConfig(),
        t_config.RolloutConfig(**ROLLOUT),
        rep_noise=[torch.from_numpy(n) for n in noise],
        **(dict(decode_fn=models["dcae"].decode, **stats) if decoded else {}))
    keys = ["latent_rmse", "latent_crps"] + (["rmse_ens", "rmse_single", "crps"]
                                             if decoded else [])
    assert sorted(got) == sorted(keys)
    for k in keys:
        w = np.concatenate([m[k] for m in want])
        assert got[k].shape == w.shape == ((N, n_steps) if k.startswith("latent")
                                           else (N, 84, n_steps))
        assert _rel(got[k], w) <= 1e-5, (k, _rel(got[k], w))


def _fixtures(tmp_path, models=None):
    cfg = {"ar_model": {k: list(v) if isinstance(v, tuple) else v
                        for k, v in DIT_KW.items()},
           "general": {"checkpointing_steps": 100},
           "train_dataloader": {"batch_size": 2, "input_seq_len": 1,
                                "return_seq_len": 2, "interval_between_pred": 1},
           "ema": {"ema_update_after_step": 0}}
    rng = np.random.RandomState(3)
    for name, n in (("train", 12), ("val", 8)):
        np.savez(tmp_path / f"{name}.npz",
                 latents=rng.randn(n, H, W, 84).astype(np.float32),
                 timestamps=np.asarray([add_hours_int(2018010100, 6 * i)
                                        for i in range(n)], np.int64))
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    return ["--config", str(tmp_path / "cfg.yaml"), "--latents",
            str(tmp_path / "train.npz"), "--output_dir", str(tmp_path / "run"),
            "--device", "cpu", "--log_every", "1", "--val_latents",
            str(tmp_path / "val.npz"), "--val_ensemble_size", "2",
            "--val_num_init_times", "2", "--val_total_lead_time_hour", "12",
            "--val_num_inference_steps", "2"]


def test_train_ar_validates_every_n_steps(tmp_path, models):
    """--val_every with --val_latents runs; with --val_dcae_params the
    decoded per-variable tables by lead time."""
    dcae_dir = str(tmp_path / "dcae")
    t_hub.save_pretrained(dcae_dir, "dcae", t_config.DCAEConfig(**DCAE_KW),
                          models["dcae"].state_dict())
    argv = _fixtures(tmp_path) + ["--num_steps", "3", "--val_every", "2",
                                  "--val_dcae_params", dcae_dir]
    res = t_cli.main(argv)
    assert [v["step"] for v in res["validations"]] == [2]
    v = res["validations"][-1]
    assert np.isfinite(v["val_latent_rmse"]) and np.isfinite(v["val_latent_crps"])
    table = v["val_rmse_ens"]
    assert table["lead_hours"] == [6, 12]
    assert len(table) == 85 and all(np.isfinite(table["2m_temperature"]))
    logs = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text()
            .splitlines()]
    assert sum("val_latent_rmse" in x for x in logs) == 1
