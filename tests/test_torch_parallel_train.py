"""The port's trainers over two gloo ranks on the CPU against one process
and against the JAX package: the AR trainer under DDP (``--mesh data=2``),
HSDP (``--mesh data=1,model=2``, the replica's two rows split over the
model group) and FSDP (``--mesh data=2 --zero``, also with push-forward 2),
its averaged gradients, its checkpoints across the two layouts, and the
DCAE trainer data-parallel. The ranks come from ``test_torch_parallel.spawn``:
one spawn runs every two-rank case of this file (:func:`two_rank_job`),
since a spawn's start costs tens of seconds on a busy host, and the module
fixture :func:`world` also runs the one-process references.

Tolerances: fp32 compute (``--compute_dtype float32``), so two ranks differ
from one process only in the order of the sums of the gradient's batch
rows: losses and gradient norms to 1e-5 relative. Parameters: Adam divides
each gradient element by its own RMS, so an element whose gradient is near
zero carries its sum's rounding into the update at full size (up to 4e-5,
4 % of one step at the tests' learning rate of 1e-3, after three steps;
3.5e-5 relative L2 of the whole update). So the weights agree to 1e-4
absolute and the updates from the initial weights to 1e-4 relative L2
(:func:`_same_params`), and a checkpoint's AdamW moments to 1e-4 relative L2
per tensor. The gradients against JAX's as
``test_torch_train`` holds one process's (1e-5 relative L2 for the whole,
1e-4 per parameter).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from ladcast_torch.data.time_utils import add_hours_int
from ladcast_torch.parallel import dist
from test_torch_parallel import spawn

TINY_DIT = dict(in_channels=6, out_channels=6, num_attention_heads=2,
                attention_head_dim=128, num_layers=1, num_single_layers=1,
                num_refiner_layers=1, mlp_ratio=2.0,
                conditioning_tensor_in_channels=6)
AR_CFG = {
    "ar_model": {"num_attention_heads": 2, "attention_head_dim": 128,
                 "num_layers": 1, "num_single_layers": 1,
                 "num_refiner_layers": 1, "mlp_ratio": 1},
    "general": {"checkpointing_steps": 2, "checkpoints_total_limit": 3,
                "compute_dtype": "float32"},
    "train_dataloader": {"batch_size": 2, "input_seq_len": 1, "return_seq_len": 4},
    "lr_scheduler": {"num_warmup_steps": 0},
    "optimizer": {"lr": 1e-3},
    "ema": {"ema_update_after_step": 0},
}
# flags, the yaml's batch_size (rows per data replica): one row a rank in
# each regime, HSDP's replica of two rows split over its model group
REGIMES = {"ddp": (["--mesh", "data=2"], 1), "hsdp": (["--mesh", "data=1,model=2"], 2),
           "fsdp": (["--mesh", "data=2", "--zero"], 1)}


def _ar_cfg(batch_size):
    return {**AR_CFG, "train_dataloader": {**AR_CFG["train_dataloader"],
                                           "batch_size": batch_size}}


def _argv(latents, out, steps, *extra):
    return ["--latents", latents, "--output_dir", str(out), "--num_steps", str(steps),
            "--device", "cpu", "--log_every", "1", "--seed", "3", *extra]


def train_ar_job(cfg, argv, weights=()):
    """``cli.train_ar.run``; the run's metrics and, as ``weights`` asks,
    the weights after it: "full" the whole model gathered to rank 0 (an
    empty dict elsewhere), "own" this rank's state dict."""
    from ladcast_torch.cli import train_ar

    res = train_ar.run(cfg, train_ar.build_parser().parse_args(argv))
    state = res["state"]
    out = {"loss": [h["loss"] for h in res["history"]],
           "grad_norm": [h["grad_norm"] for h in res["history"]],
           "val": [v["val_latent_crps"] for v in res["validations"]],
           "step": state.step, "regime": state.regime, "rows": res["rows"]}
    if "full" in weights:
        out["full"] = dist.full_state_dict(state.model)
    if "own" in weights:
        out["own"] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return out


def _close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _init_params():
    from ladcast_torch.config import LaDCastDiTConfig, config_from_dict
    from ladcast_torch.models.ladcast_dit import build_dit

    return build_dit(config_from_dict(LaDCastDiTConfig, AR_CFG["ar_model"]), "cpu",
                     torch.float32, 3).state_dict()


def _same_params(got, want, init=None):
    """Each weight to 1e-4 absolute; with the initial weights ``init``, the
    whole update to 1e-4 relative L2 (the module docstring)."""
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k].to(got[k].device), rtol=1e-5,
                                   atol=1e-4, msg=k)
    if init is not None:
        d_got = torch.cat([(got[k].cpu() - init[k]).flatten() for k in init])
        d_want = torch.cat([(want[k].cpu() - init[k]).flatten() for k in init])
        assert (d_got - d_want).norm() <= 1e-4 * d_want.norm()


def grads_job(sd, batch, indices, noise, mesh_spec, zero, remat):
    """The loss and gradients of ``loss_given_noise`` over a mesh, each rank
    on its rows of the global batch, with the JAX weights ``sd``: the
    trainer's own ``reduced_grads`` (averaged under DDP, reduce-scattered
    under FSDP and HSDP), gathered whole on rank 0."""
    from ladcast_torch import config
    from ladcast_torch.parallel import mesh
    from ladcast_torch.parallel import sharding_rules as rules
    from ladcast_torch.train import optim
    from ladcast_torch.train.trainer_ar import (
        ARTrainConfig,
        make_ar_train_step,
        reduced_grads,
    )

    m = mesh.make_mesh_from_spec(mesh_spec, "cpu")
    init_fn, step = make_ar_train_step(
        config.LaDCastDiTConfig(**TINY_DIT), config.EDMSchedulerConfig(),
        config.NoiseSamplerConfig(), ARTrainConfig(compute_dtype="float32", remat=remat),
        optim.make_optimizer(), device="cpu", mesh=m, zero=zero,
        batch_size=len(indices) // m["data"].size())
    state = init_fn(0)
    state.load_full_params(sd if dist.process_index() == 0 else None)
    rows = dist.batch_feed_slice(m, len(indices))
    loss, aux = step.loss_given_noise(
        state.model, [torch.from_numpy(x[rows]) for x in batch],
        torch.from_numpy(indices[rows]).long(), torch.from_numpy(noise[rows]))
    grads = reduced_grads(state, loss, [aux["loss"]])
    names, params = zip(*state.model.named_parameters())
    grads = rules.full_tensors(grads, params)  # None on rank 1
    return {"regime": state.regime, "loss": float(aux["loss"]),
            "grads": dict(zip(names, grads))}


GRAD_CASES = {"ddp": ("data=2", False, False), "fsdp": ("data=2", True, False),
              "hsdp_remat": ("data=1,model=2", True, True)}  # mesh, zero, remat


# ------------------------------------------------------------ the DCAE ----

DCAE = dict(in_channels=89, out_channels=89, latent_channels=8, attention_head_dim=4,
            encoder_block_types=["ResBlock", "ResBlock"],
            decoder_block_types=["ResBlock", "ResBlock"],
            encoder_block_out_channels=[8, 16], decoder_block_out_channels=[8, 16],
            encoder_layers_per_block=[1, 1], decoder_layers_per_block=[1, 1],
            encoder_qkv_multiscales=[[], []], decoder_qkv_multiscales=[[], []],
            static_channels=5)


def _dcae_cfg(batch_size):
    return {"encdec": DCAE, "optimizer": {"lr": 1e-3},
            "lr_scheduler": {"num_warmup_steps": 0},
            "train": {"batch_size": batch_size, "subbatch_steps": 2,
                      "lat_weighted_loss": True},
            "general": {"checkpointing_steps": 1000},
            "ema": {"use_ema": True, "ema_update_after_step": 0}}


def train_dcae_job(cfg, argv):
    """``cli.train_dcae.run`` with an fp32 trainer (the CLI's is bf16), so
    that the batch split changes only the order of sums."""
    import functools

    from ladcast_torch.cli import train_dcae

    config = train_dcae.DCAETrainConfig
    train_dcae.DCAETrainConfig = functools.partial(config, compute_dtype="float32")
    try:
        res = train_dcae.run(cfg, train_dcae.build_parser().parse_args(argv))
    finally:
        train_dcae.DCAETrainConfig = config
    return {"loss": [h["loss"] for h in res["history"]],
            "grad_norm": [h["grad_norm"] for h in res["history"]],
            "val_loss": [v["val_loss"] for v in res["validations"]],
            "regime": res["state"].regime}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The test suite runs files in parallel workers on a shared CPU; two
    intra-op threads per worker keep them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_latents(path, h, w, seed):
    rng = np.random.RandomState(seed)
    np.savez(path, latents=rng.randn(40, h, w, 84).astype(np.float32),
             timestamps=np.asarray([add_hours_int(2018010100, i) for i in range(40)]))
    return str(path)


def _val_args(latents):
    return ["--val_every", "1", "--val_latents", latents, "--val_ensemble_size", "2",
            "--val_num_init_times", "1", "--val_total_lead_time_hour", "24",
            "--val_num_inference_steps", "2"]


def _dcae_argv(root, out):
    return ["--data", os.path.join(root, "train.npz"), "--val_data",
            os.path.join(root, "val.npz"), "--val_every", "3", "--num_steps", "3",
            "--output_dir", os.path.join(root, out), "--device", "cpu",
            "--log_every", "1", "--seed", "1"]


FSDP = ["--mesh", "data=2", "--zero"]


PF2 = ["--num_push_forward_steps", "2"]


def two_rank_job(root, latents, val_latents, jax_inputs):
    """Every two-rank case of this file in one pair of ranks: the three
    regimes' runs (three steps, global batch 2; the FSDP run exports its
    weights), an FSDP run with push-forward 2, an FSDP resume of one
    process's step-3 checkpoint, an FSDP run with a validation rollout, the
    gradients against JAX, and the DCAE."""
    out = {}
    for regime, (flags, per_rank) in REGIMES.items():
        out[regime] = train_ar_job(
            _ar_cfg(per_rank),
            _argv(latents, os.path.join(root, regime), 3, *flags,
                  *(["--hub_export"] if regime == "fsdp" else [])),
            ("full", "own") if regime == "ddp" else ("full",))
    out["fsdp_pf2"] = train_ar_job(
        _ar_cfg(1), _argv(latents, os.path.join(root, "fsdp_pf2"), 3, *FSDP, *PF2))
    out["fsdp_resume"] = train_ar_job(
        _ar_cfg(1), _argv(latents, os.path.join(root, "one_for_fsdp"), 4, *FSDP,
                          "--resume", "latest"))
    out["fsdp_val"] = train_ar_job(
        _ar_cfg(1), _argv(val_latents, os.path.join(root, "val_two"), 1, *FSDP,
                          *_val_args(val_latents)))
    out["grads"] = {name: grads_job(*jax_inputs, *case) for name, case in GRAD_CASES.items()}
    out["dcae"] = train_dcae_job(_dcae_cfg(1), _dcae_argv(root, "dcae_two"))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The data, the one-process references and the two ranks' results."""
    from ladcast_torch.models.weight_import import state_dict_from_flax
    from tests.test_torch_train import _batch, _jax_params

    tmp = tmp_path_factory.mktemp("parallel_train")
    latents = _write_latents(tmp / "latents.npz", 3, 6, 8)
    # the validator weighs the latent grid's 15 rows; 6 columns keep it small
    val_latents = _write_latents(tmp / "val_latents.npz", 15, 6, 9)
    rng = np.random.RandomState(0)
    for name, n, start in (("train", 6, 2017060100), ("val", 2, 2018030100)):
        fields = rng.randn(n, 120, 240, 84).astype(np.float32)
        fields[:, 10:20, 30:50, 82] = np.nan
        np.savez(tmp / f"{name}.npz", fields=fields, timestamps=np.asarray(
            [add_hours_int(start, 6 * i) for i in range(n)], np.int64))
    one = train_ar_job(_ar_cfg(2), _argv(latents, tmp / "one", 3, "--hub_export"), ("own",))
    shutil.copytree(tmp / "one", tmp / "one_for_fsdp")
    refs = {"one": one,
            "pf2": train_ar_job(_ar_cfg(2), _argv(latents, tmp / "one_pf2", 3, *PF2)),
            "val": train_ar_job(_ar_cfg(2), _argv(val_latents, tmp / "val_one", 1,
                                                  *_val_args(val_latents))),
            "dcae": train_dcae_job(_dcae_cfg(2), _dcae_argv(str(tmp), "dcae_one"))}
    batch, indices, noise = _batch()
    sd = {k: torch.from_numpy(np.asarray(v).copy())
          for k, v in state_dict_from_flax(_jax_params(3), "dit").items()}
    ranks = spawn(two_rank_job, 2, tmp, str(tmp), latents, val_latents,
                  (sd, batch, indices, noise))
    # the checkpoints each run wrote, before the tests resume from them
    ckpts = {d: sorted(os.listdir(tmp / d / "ckpts")) for d in ("one", *REGIMES)}
    return {"dir": tmp, "latents": latents, "ranks": ranks, "ckpts": ckpts, **refs}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_train_ar_over_two_ranks_matches_one(world, regime):
    """Three steps over two ranks, global batch 2, each rank its own row
    (HSDP: the replica's two rows split over the model group), against one
    process with batch 2: the same losses, gradient norms and final
    weights."""
    one = world["one"]
    r0, r1 = (r[regime] for r in world["ranks"])
    assert one["regime"] == "single" and r0["regime"] == r1["regime"] == regime
    assert (r0["rows"], r1["rows"]) == (slice(0, 1), slice(1, 2))  # disjoint
    for rec in (r0, r1):  # the logged metrics are the global batch's
        assert rec["step"] == 3
        _close(rec["loss"], one["loss"])
        _close(rec["grad_norm"], one["grad_norm"])
    _same_params(r0["full"], one["own"], _init_params())
    assert r1["full"] == {}  # gathered to rank 0
    # rank 0 wrote the run's files, the checkpoints in one process's layout
    assert world["ckpts"][regime] == world["ckpts"]["one"]


# Push-forward 2 under FSDP against one process, fp32: two DiT calls a step,
# each FSDP unit sums the calls' gradients before its reduce-scatter where
# one device sums them into the whole gradient. Readings of the spread
# (four seeds, four steps each, two ranks against one process on the CPU):
# losses within 1.6e-7 relative and gradient norms within 8.2e-7, so the
# push-forward-1 cases' 1e-5 holds with a margin of twelve. (In bf16 the same
# runs read 2.6e-4 and 1.9e-3, from the first step on: there a rank's
# one-row GEMMs round differently from one process's two-row ones, before
# any push-forward sum; the file's runs are fp32 for that reason.)
PF2_RTOL = 1e-5


def test_fsdp_push_forward_two_matches_one_process(world):
    """Three steps of ``--num_push_forward_steps 2`` under ``--mesh data=2
    --zero``, one row a rank, against one process with batch 2: the same
    losses and gradient norms to PF2_RTOL."""
    one = world["pf2"]
    assert one["regime"] == "single" and one["step"] == 3
    for rank in world["ranks"]:
        rec = rank["fsdp_pf2"]
        assert rec["regime"] == "fsdp" and rec["step"] == 3
        _close(rec["loss"], one["loss"], rtol=PF2_RTOL)
        _close(rec["grad_norm"], one["grad_norm"], rtol=PF2_RTOL)
    # the second DiT call's gradient moved the step: push-forward 1 differs
    assert not np.allclose(one["loss"][1:], world["one"]["loss"][1:], rtol=1e-4)


def test_fsdp_validation_matches_one_process(world):
    """A validation rollout of FSDP-sharded weights (gathered whole, run by
    an unsharded copy on rank 0, its record sent to both ranks) scores as
    one process's, on latents of the validator's 15 rows."""
    for rank in world["ranks"]:
        rec = rank["fsdp_val"]
        assert rec["regime"] == "fsdp" and len(rec["val"]) == 1
        _close(rec["loss"], world["val"]["loss"])
        _close(rec["val"], world["val"]["val"])


def test_ddp_averages_the_gradients_of_different_rows(world):
    """Each rank on its own row of the global batch (``--mesh data=2``,
    batch 1 a rank): after three steps both ranks hold the same parameters,
    bit for bit, and they are the one-process steps' on the union batch,
    which moved every one of them."""
    r0, r1 = (r["ddp"]["own"] for r in world["ranks"])
    for k, v in r0.items():
        assert torch.equal(v, r1[k]), k
    init = _init_params()
    _same_params(r0, world["one"]["own"], init)
    moved = sum(not torch.equal(init[k], v) for k, v in world["one"]["own"].items())
    assert moved == len(init)


def test_checkpoints_cross_between_fsdp_and_one_process(world):
    """One process's step-3 checkpoint resumes under FSDP over two ranks,
    and the step-3 checkpoint the FSDP ranks wrote resumes in one process:
    each next step's loss is one process's resumed from its own. The FSDP
    checkpoint and hub export hold one process's weights and moments."""
    from ladcast_torch.models import hub

    tmp, latents = world["dir"], world["latents"]
    one4 = train_ar_job(_ar_cfg(2), _argv(latents, tmp / "one", 4, "--resume", "latest"))
    from_fsdp = train_ar_job(_ar_cfg(2), _argv(latents, tmp / "fsdp", 4, "--resume",
                                                "latest"))
    assert one4["step"] == from_fsdp["step"] == 4
    _close(from_fsdp["loss"], one4["loss"])
    for rank in world["ranks"]:
        assert rank["fsdp_resume"]["step"] == 4
        _close(rank["fsdp_resume"]["loss"], one4["loss"])
    fa = torch.load(tmp / "one" / "ckpts" / "step_00000003.pt", weights_only=True)
    fb = torch.load(tmp / "fsdp" / "ckpts" / "step_00000003.pt", weights_only=True)
    assert fa.keys() == fb.keys() and fa["step"] == fb["step"] == 3
    _same_params(fb["params"], fa["params"])
    # the moments average gradients whose batch sums differ in order, and
    # the elements of cancelling sums carry that at 1e-4 to 1e-3 relative:
    # each moment to 1e-4 relative L2
    for key in ("mu", "nu"):
        for x, y in zip(fb["opt_state"][key], fa["opt_state"][key]):
            assert (x - y).norm() <= 1e-4 * y.norm(), key
    # the diffusers export of the sharded weights and EMA, written by rank 0
    for sub in ("ar_model", "ar_model_ema"):
        _same_params(hub.load_pretrained(str(tmp / "fsdp" / "hub" / sub)).params,
                     hub.load_pretrained(str(tmp / "one" / "hub" / sub)).params)


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_two_rank_gradients_match_jax(world, case):
    """The JAX loss and gradients of the whole batch (``test_torch_train``'s
    push-forward-1 case) from two ranks: two rows split one each, over the
    data axis (DDP, FSDP) or over the model group (HSDP, with the per-block
    checkpoint running on the gathered parameters)."""
    from tests.test_torch_train import _assert_loss_and_grads_match, _jax_loss_and_grads

    j_loss, want = _jax_loss_and_grads("pf1")
    r0, r1 = (r["grads"][case] for r in world["ranks"])
    assert r0["regime"] == case.split("_")[0]
    assert r0["loss"] == r1["loss"]
    _assert_loss_and_grads_match(r0["loss"], r0["grads"], j_loss, want)


def test_train_dcae_over_two_ranks_matches_one(world):
    """Three steps (unrolled, rolled, a new batch) and a validation, one
    row per rank, against one process with batch 2: the same losses,
    gradient norms and validation loss, and the same best weights, which
    rank 0 wrote."""
    from ladcast_torch.models import hub

    one = world["dcae"]
    assert one["regime"] == "single"
    for rank in world["ranks"]:
        rec = rank["dcae"]
        assert rec["regime"] == "ddp"
        _close(rec["loss"], one["loss"])
        _close(rec["grad_norm"], one["grad_norm"])
        _close(rec["val_loss"], one["val_loss"])
    a = hub.load_pretrained(str(world["dir"] / "dcae_one" / "best" / "step-3")).params
    b = hub.load_pretrained(str(world["dir"] / "dcae_two" / "best" / "step-3")).params
    _same_params(b, a)
