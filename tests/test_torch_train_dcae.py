"""The port's DCAE trainer against the JAX package's, in fp32 on the CPU,
on a tiny DCAE at the real 120 x 240 grid with the real statics: the loss
and its gradients with an injected per-sample roll (under both conv
modes), three AdamW + EMA steps, decoder-only finetuning, and the
``train_dcae`` CLI with validation, best-weight rotation and resume."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ladcast_torch import channels as t_ch
from ladcast_torch import config as t_config
from ladcast_torch import static_data as t_static
from ladcast_torch.cli import pred_rollout as t_pred
from ladcast_torch.cli import train_dcae as t_cli
from ladcast_torch.data.time_utils import add_hours_int
from ladcast_torch.models.dcae import AutoencoderDC as TorchAE
from ladcast_torch.models.weight_import import state_dict_from_flax
from ladcast_torch.ops import sphere as t_sphere
from ladcast_torch.train import ema as t_ema
from ladcast_torch.train import optim as t_optim
from ladcast_torch.train.trainer_ar import TrainState
from ladcast_torch.train.trainer_dcae import (
    DCAETrainConfig as TCfg,
    make_dcae_train_step as t_make,
    roll_samples,
)
from ladcast_tpu import config as j_config
from ladcast_tpu import static_data as j_static
from ladcast_tpu.train import optim as j_optim
from ladcast_tpu.train.trainer_dcae import (
    DCAETrainConfig as JCfg,
    make_dcae_train_step as j_make,
)

TINY = dict(in_channels=89, out_channels=89, latent_channels=8,
            attention_head_dim=4,
            encoder_block_types=("ResBlock", "ResBlock"),
            decoder_block_types=("ResBlock", "ResBlock"),
            encoder_block_out_channels=(8, 16), decoder_block_out_channels=(8, 16),
            encoder_layers_per_block=(1, 1), decoder_layers_per_block=(1, 1),
            encoder_qkv_multiscales=((), ()), decoder_qkv_multiscales=((), ()),
            static_channels=5)
TINY_CFG = {  # the JAX CLI test's config, as PyYAML reads it
    "encdec": {**{k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
               "encoder_qkv_multiscales": [[], []],
               "decoder_qkv_multiscales": [[], []]},
    "optimizer": {"lr": 1e-3},
    "lr_scheduler": {"num_warmup_steps": 0},
    "train": {"batch_size": 1, "subbatch_steps": 2, "lat_weighted_loss": True},
    "general": {"checkpointing_steps": 1000, "val_every_steps": 2},
    "ema": {"use_ema": True, "ema_update_after_step": 0},
}


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
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    B = 2
    fields = rng.randn(B, 120, 240, 84).astype(np.float32)
    nan_mask = np.zeros((B, 120, 240), bool)
    nan_mask[:, 20:50, 30:90] = True  # SST over "land"
    fields[..., 82][nan_mask] = -2.0
    statics = j_static.static_conditioning_tensor(layout="HWC").astype(np.float32)
    np.testing.assert_allclose(t_static.static_conditioning_tensor(layout="HWC"),
                               statics, rtol=0, atol=1e-6)
    jcfg = j_config.DCAEConfig(**TINY)
    opt = j_optim.make_optimizer(lr=1e-3, num_warmup_steps=0, num_training_steps=10)
    jtcfg = JCfg(subbatch_steps=1, ema_update_after_step=0, compute_dtype="float32")
    init_fn, step_fn, _ = j_make(jcfg, jtcfg, opt)
    jstate = jax.jit(init_fn)(jax.random.PRNGKey(0), (
        jnp.asarray(fields), jnp.asarray(nan_mask), jnp.asarray(statics)))
    params = jax.tree.map(np.asarray, jstate.params)
    return dict(fields=fields, nan_mask=nan_mask, statics=statics, jcfg=jcfg,
                jtcfg=jtcfg, opt=opt, params=params, jstate=jstate, step_fn=step_fn)


def _torch_state(setup, tcfg, lr=1e-3, trainable_mask=None):
    model = TorchAE(t_config.DCAEConfig(**TINY))
    model.load_state_dict(state_dict_from_flax(setup["params"], "dcae"), strict=True)
    opt = t_optim.make_optimizer(lr=lr, num_warmup_steps=0, num_training_steps=10,
                                 trainable_mask=trainable_mask)
    init, step, ev = t_make(t_config.DCAEConfig(**TINY), tcfg, opt, "cpu")
    state = TrainState(model, opt(model.named_parameters()),
                       t_ema.ema_init(model.parameters()), 0)
    return state, step, ev


def _batch(setup):
    return (torch.from_numpy(setup["fields"]), torch.from_numpy(setup["nan_mask"]),
            torch.from_numpy(setup["statics"]))


def test_roll_samples_is_jnp_roll_per_sample():
    x = np.arange(2 * 6 * 8 * 3).reshape(2, 6, 8, 3).astype(np.float32)
    roll = [(3, 1), (5, 4)]  # (x, y) per sample
    want = np.stack([np.roll(x[b], (-y, -xx), axis=(0, 1))
                     for b, (xx, y) in enumerate(roll)])
    np.testing.assert_array_equal(roll_samples(torch.from_numpy(x), roll).numpy(), want)


@pytest.mark.parametrize("mode", ["kernel", "library"])
def test_loss_given_roll_and_grads_match_jax(setup, monkeypatch, mode):
    """Per-sample rolls of different x and y (a swapped axis fails), SST
    masking, statics in the target; loss and every gradient."""
    monkeypatch.setattr(t_sphere, "CONV_MODE", mode)
    roll = np.asarray([[37, 11], [200, 93]], np.int32)
    jloss_fn = setup["step_fn"].loss_given_roll
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        setup["params"], jnp.asarray(setup["fields"]), jnp.asarray(setup["nan_mask"]),
        jnp.asarray(setup["statics"]), jnp.asarray(roll))
    state, step, _ = _torch_state(setup, TCfg(compute_dtype="float32"))
    params = list(state.model.parameters())
    tl, taux = step.loss_given_roll(state.model, *_batch(setup), roll.tolist())
    grads = torch.autograd.grad(tl, params)
    assert _rel(tl.item(), float(jl)) <= 1e-5
    assert _rel(taux["loss_per_var"].numpy(), jaux["loss_per_var"]) <= 1e-5
    assert taux["loss_per_var"].shape == (6 + 6 + 5,)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jg), "dcae")
    names = [n for n, _ in state.model.named_parameters()]
    for n, g in zip(names, grads):
        assert _rel(g.numpy(), want[n].numpy()) <= 1e-4, n
    # a roll of zeros is no roll
    l0, _ = step.loss_given_roll(state.model, *_batch(setup), [[0, 0], [0, 0]])
    l1, _ = step.loss_given_roll(state.model, *_batch(setup), None)
    assert l0.item() == l1.item()


def test_three_adamw_ema_steps_match_jax(setup):
    """subbatch_steps=1: no step rolls, in either package, so the steps
    compare; parameters and EMA after three steps."""
    jstate = setup["jstate"]
    batch_j = (jnp.asarray(setup["fields"]), jnp.asarray(setup["nan_mask"]),
               jnp.asarray(setup["statics"]))
    state, step, ev = _torch_state(setup, TCfg(subbatch_steps=1, ema_update_after_step=0,
                                               compute_dtype="float32"))
    for i in range(3):
        jstate, jaux = jax.jit(setup["step_fn"])(jstate, batch_j, jax.random.PRNGKey(i))
        aux = step(state, _batch(setup), seed=i)
        assert _rel(aux["loss"].item(), float(jaux["loss"])) <= 1e-5
        assert _rel(aux["grad_norm"].item(), float(jaux["grad_norm"])) <= 1e-5
    assert state.step == int(jstate.step) == 3
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params), "dcae")
    want_ema = state_dict_from_flax(jax.tree.map(np.asarray, jstate.ema.params), "dcae")
    names = [n for n, _ in state.model.named_parameters()]
    for n, p, e in zip(names, state.model.parameters(), state.ema.params):
        assert _rel(p.detach().numpy(), want[n].numpy()) <= 1e-5, n
        assert _rel(e.numpy(), want_ema[n].numpy()) <= 1e-5, n
    # eval_step: the EMA weights' per-channel MSE over the 89 outputs
    out = ev(state.model, _batch(setup), state.ema.params)
    assert out["channel_mse"].shape == out["channel_lw_mse"].shape == (89,)
    assert torch.isfinite(out["channel_lw_mse"]).all()


def test_decoder_only_mask_freezes_the_encoder(setup):
    names = [n for n, _ in TorchAE(t_config.DCAEConfig(**TINY)).named_parameters()]
    flags = {n: t_optim.decoder_only_mask(n) for n in names}
    assert any(flags.values()) and not all(flags.values())
    assert all(v == n.startswith("decoder.") for n, v in flags.items())
    state, step, _ = _torch_state(setup, TCfg(compute_dtype="float32"),
                                  trainable_mask=t_optim.decoder_only_mask)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    for i in range(2):
        step(state, _batch(setup), seed=i)
    for n, p in state.model.named_parameters():
        moved = not torch.equal(p, before[n])
        assert moved == flags[n], n


def _write_npz(path, n, seed, start=2017060100):
    rng = np.random.RandomState(seed)
    fields = rng.randn(n, 120, 240, 84).astype(np.float32)
    fields[:, 10:20, 30:50, 82] = np.nan
    ts = np.asarray([add_hours_int(start, 6 * i) for i in range(n)], np.int64)
    np.savez(path, fields=fields, timestamps=ts)


def _args(tmp_path, *extra):
    return t_cli.build_parser().parse_args(
        ["--data", str(tmp_path / "train.npz"), "--output_dir", str(tmp_path / "run"),
         "--device", "cpu", "--log_every", "1", *extra])


def test_cli_validation_rotation_resume_and_finetune(tmp_path):
    _write_npz(tmp_path / "train.npz", 6, 0)
    _write_npz(tmp_path / "val.npz", 3, 1, start=2018030100)  # the validation year
    best = tmp_path / "run" / "best"
    best.mkdir(parents=True)
    for s in range(91, 96):  # older bests: the rotation keeps the newest 2
        (best / f"step-{s}").mkdir()
    val = ["--val_data", str(tmp_path / "val.npz"), "--val_every", "2"]
    res = t_cli.run(TINY_CFG, _args(tmp_path, "--num_steps", "3", *val))
    assert [h["step"] for h in res["history"]] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in res["history"])
    assert [v["step"] for v in res["validations"]] == [2, 3]
    logs = [json.loads(x) for x in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    val_logs = [x for x in logs if "val_loss" in x]
    assert len(val_logs) == 2 and np.isfinite(val_logs[-1]["val_loss"])
    assert "val_rmse_sea_surface_temperature" in val_logs[-1]
    assert "val_lw_rmse_land_sea_mask" in val_logs[-1]
    kept = sorted(os.listdir(best))
    # the newest best is the lowest validation loss so far
    newest = min(res["validations"], key=lambda v: v["val_loss"])["step"]
    assert kept == sorted([f"step-{newest}", "step-94", "step-95"])
    # a best directory is a diffusers model directory every CLI loads
    params, cfg = t_pred._load_any_params(str(best / f"step-{newest}"), "dcae", None)
    assert cfg == t_config.config_from_dict(t_config.DCAEConfig, TINY_CFG["encdec"])
    assert len(params) == len(list(res["state"].model.parameters()))

    # resume: the saved state comes back whole, then trains on
    state = res["state"]
    again = t_cli.run(TINY_CFG, _args(tmp_path, "--num_steps", "3", "--resume", "latest"))
    assert again["state"].step == 3 and not again["history"]
    for a, b in zip(state.model.parameters(), again["state"].model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(state.optimizer.mu, again["state"].optimizer.mu):
        assert torch.equal(a, b)
    on = t_cli.run(TINY_CFG, _args(tmp_path, "--num_steps", "4", "--resume", "3"))
    assert on["state"].step == 4 and [h["step"] for h in on["history"]] == [4]

    # decoder finetuning from the best weights: the encoder stays as loaded
    ft_cfg = {**TINY_CFG, "train": {**TINY_CFG["train"], "ft_decoder_only": True}}
    ft = t_cli.run(ft_cfg, t_cli.build_parser().parse_args(
        ["--data", str(tmp_path / "train.npz"), "--output_dir", str(tmp_path / "ft"),
         "--device", "cpu", "--num_steps", "2", "--init_weights", str(best / f"step-{newest}")]))
    for (n, p) in ft["state"].model.named_parameters():
        moved = not torch.equal(p.detach(), params[n])
        assert moved == n.startswith("decoder."), n


def test_cli_refusals(tmp_path, monkeypatch):
    _write_npz(tmp_path / "train.npz", 2, 0)
    # a parallel: section for more ranks than the run has: the mesh-size
    # error of the JAX mesh; the DCAE is data-parallel only
    with pytest.raises(ValueError, match="!= 1 devices"):
        t_cli.run({**TINY_CFG, "parallel": {"mesh": {"data": 8}}},
                  _args(tmp_path, "--num_steps", "1"))
    with pytest.raises(ValueError, match="data-parallel only"):
        t_cli.run({**TINY_CFG, "parallel": {"mesh": {"data": -1}, "zero": True}},
                  _args(tmp_path, "--num_steps", "1"))
    import sys

    with monkeypatch.context() as m:  # a zarr source needs xarray
        m.setitem(sys.modules, "xarray", None)
        with pytest.raises(ImportError, match="xarray"):
            t_cli.run(TINY_CFG, t_cli.build_parser().parse_args(
                ["--data", str(tmp_path / "era5.zarr"), "--device", "cpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_cli.run(TINY_CFG, t_cli.build_parser().parse_args(
                ["--data", str(tmp_path / "train.npz")]))
    assert t_ch.STATIC_NAMES == ("land_sea_mask", "oro_1", "oro_2", "oro_3", "oro_4")


@pytest.mark.parametrize("name", ["dcae_84", "dcae_84_ft_decoder"])
def test_chip_smoke_dcae_configs_are_the_yamls(name):
    """chip_smoke.py trains on copies of the shipped configs (the card's
    machine has no PyYAML)."""
    import yaml

    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", f"{name}.yaml")) as f:
        want = yaml.safe_load(f)
    got = {"dcae_84": chip_smoke.DCAE_84_YAML,
           "dcae_84_ft_decoder": chip_smoke.DCAE_84_FT_YAML}[name]
    assert got == want
