"""The port's parallelism (``ladcast_torch/parallel/``) on the CPU with gloo:
the mesh parser against the JAX function, the process helpers against the
JAX semantics, and the forecast and scoring CLIs over two ranks against one
process.

Ranks are separate processes spawned by :func:`spawn` (``torch.
multiprocessing``, a ``file://`` store in a test's temporary directory, so
parallel test workers never share a port). A job is a module-level function
of a test module that imports no JAX at module level (the children import
it), run in every rank after ``dist.initialize``; each rank's return value
comes back to the test. Every spawn has its own time limit, and each file
runs all its two-rank cases in one spawn (:func:`two_rank_job`), since a
spawn's start costs tens of seconds on a busy host.

Tolerances: the forecast files of two ranks equal one process's to 1e-5
relative (the same member draws and fp32 products; the tiny DiT's batch
split changes only the order of nothing but independent rows), and the
merged score tables to 1e-6.
"""

import os
import uuid

import numpy as np
import pytest
import torch

from ladcast_torch.parallel import dist, mesh as t_mesh

SPAWN_TIMEOUT_S = 600  # one spawn's limit; each file's spawn runs every case of it


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The test suite runs files in parallel workers on a shared CPU; two
    intra-op threads per worker keep them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _entry(rank, world, store, module, job, args, out):
    import importlib

    torch.set_num_threads(1)
    dist.initialize(backend="gloo", init_method=f"file://{store}",
                    world_size=world, rank=rank, device="cpu")
    try:
        result = getattr(importlib.import_module(module), job)(*args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def spawn(job, world, tmp_path, *args, timeout=SPAWN_TIMEOUT_S):
    """Run ``job(*args)`` in ``world`` gloo ranks; returns each rank's
    result, rank 0's first. Fails the test when a rank fails or the spawn
    outlives ``timeout`` seconds (its processes are then killed)."""
    import time

    import torch.multiprocessing as mp

    tag = uuid.uuid4().hex[:8]
    out = tmp_path / f"ranks_{tag}"
    out.mkdir()
    ctx = mp.start_processes(
        _entry, args=(world, str(tmp_path / f"store_{tag}"), job.__module__,
                      job.__name__, args, str(out)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise AssertionError(f"{job.__name__} over {world} ranks outlived "
                                     f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ----------------------------------------------------------- the mesh ----

MESH_SPECS = ["data=-1", "data=-1,model=2", {"data": -1, "model": 8},
              {"data": 2, "model": 4}, "model=2,data=-1", "data=4", "data=3",
              "data=-1,model=-1", "data=0", {"data": -1, "seq": 3}, {}]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", MESH_SPECS, ids=str)
def test_mesh_sizes_match_jax(spec, n):
    """The axis sizes of a spec over n ranks are the JAX mesh's over n
    devices, and a spec JAX refuses raises the same error."""
    import jax

    from ladcast_tpu.parallel import mesh as j_mesh

    try:
        want = j_mesh.make_mesh_from_spec(spec, jax.devices()[:n]).shape
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_mesh.mesh_sizes(spec, n)
        assert str(got.value) == str(e)
        return
    assert t_mesh.mesh_sizes(spec, n) == list(want.items())


def test_single_process_helpers_match_jax():
    """Without a process group every helper keeps its one-process meaning,
    the JAX package's: rank 0 of 1, no mesh, every row, every item, the
    seed as given."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ladcast_tpu.parallel import dist as j_dist
    from ladcast_tpu.parallel import mesh as j_mesh

    assert not dist.is_initialized()
    dist.initialize(device="cpu")  # no WORLD_SIZE above 1: a no-op
    assert not dist.is_initialized()
    assert (dist.process_count(), dist.process_index()) == (1, 0)
    assert t_mesh.make_mesh_from_spec("data=-1", "cpu") is None
    assert t_mesh.make_mesh("data", "cpu") is None
    assert dist.host_local_slice(8) == j_dist.host_local_slice(8)
    jm = j_mesh.make_mesh_from_spec("data=-1,model=2", jax.devices())
    assert (dist.batch_feed_slice(None, 8)
            == j_dist.batch_feed_slice(NamedSharding(jm, P("data")), 8))
    items = list(range(7))
    assert dist.shard_list(items) == j_dist.shard_list(items)
    x = np.arange(6.0).reshape(2, 3)
    for axis in (0, 1):
        np.testing.assert_array_equal(dist.all_gather_arrays(x, axis),
                                      j_dist.all_gather_arrays(x, axis))
    t = torch.arange(4.0)
    assert dist.gather_to_rank0(t) is t
    assert dist.process_seed(7) == 7
    dist.all_reduce_mean_([t])  # no group: nothing to average
    assert torch.equal(t, torch.arange(4.0))
    dist.barrier()
    assert t_mesh.pad_to_multiple(3, 2) == j_mesh.pad_to_multiple(3, 2) == 4


class _StandInMesh:
    """A (data, model) device mesh as ``batch_feed_slice`` reads it, at the
    coordinates of one rank, without a process group."""

    class _Axis:
        def __init__(self, n):
            self.n = n

        def size(self):
            return self.n

    mesh_dim_names = ("data", "model")

    def __init__(self, sizes, coords):
        self.sizes, self.coords = sizes, coords

    def __getitem__(self, name):
        return self._Axis(self.sizes[self.mesh_dim_names.index(name)])

    def get_local_rank(self, name):
        return self.coords[self.mesh_dim_names.index(name)]


@pytest.mark.parametrize("data,model,batch", [
    (1, 2, 2), (1, 2, 3), (2, 2, 4), (2, 2, 6), (1, 8, 8), (1, 8, 4)])
def test_batch_feed_slice_splits_a_replica_over_its_model_group(
        data, model, batch, capsys):
    """HSDP's rows, rank by rank of a stand-in (data, model) mesh: where a
    replica's rows divide over its model group, the group's ranks feed
    disjoint equal shares that cover the replica, and the replicas cover
    the global batch; where they do not (3 over 2, 3 over 2 per replica,
    the shipped 1.6B yaml's 4 over 8), each rank of the group feeds its
    replica's rows, and one line, printed by one rank, says so."""
    per = batch // data
    split = per % model == 0
    fed = {}
    for d in range(data):
        for k in range(model):
            m = _StandInMesh((data, model), (d, k))
            assert dist.model_rows_split(m, batch) == split
            fed[d, k] = dist.batch_feed_slice(m, batch, announce=True)
    for d in range(data):
        replica = [fed[d, k] for k in range(model)]
        if split:
            assert replica == [slice(d * per + k * per // model,
                                     d * per + (k + 1) * per // model)
                               for k in range(model)]
        else:
            assert replica == [slice(d * per, (d + 1) * per)] * model
    rows = sorted(r for s in fed.values() for r in range(s.start, s.stop))
    assert rows == (list(range(batch)) if split
                    else sorted(list(range(batch)) * model))
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == (0 if split else 1), printed
    if not split:
        assert "repeats the compute" in printed[0]


def test_a_group_that_cannot_form_raises(tmp_path):
    """No fallback: a process group asked for and not formed raises, on a
    rank beyond the world, an unknown backend, and (on a host without CUDA)
    the NCCL default of a CUDA run."""
    store = f"file://{tmp_path / 'store'}"
    with pytest.raises((ValueError, RuntimeError)):
        dist.initialize(backend="gloo", init_method=store, world_size=1, rank=3,
                        device="cpu")
    with pytest.raises((ValueError, RuntimeError, AssertionError)):
        dist.initialize(backend="no_such_backend", init_method=store,
                        world_size=1, rank=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dist.initialize(init_method=store, world_size=1, rank=0)
    assert not dist.is_initialized()


def helpers_job():
    """Every helper on a (data=1, model=2) mesh and on data=-1."""
    from ladcast_torch.parallel import mesh

    hm = mesh.make_mesh_from_spec("data=1,model=2", "cpu")
    dm = mesh.make_mesh("data", "cpu")
    rank = dist.process_index()
    x = torch.full((2, 3), float(rank))
    avg = [torch.full((5,), float(rank)), torch.full((2, 2), 10.0 * rank)]
    dist.all_reduce_mean_(avg, bucket_bytes=16)  # several buckets
    gathered = dist.gather_to_rank0(x)
    dist.barrier("helpers")
    return {"rank": rank, "count": dist.process_count(),
            "hsdp": (hm.mesh_dim_names, tuple(hm.shape)),
            "data": (dm.mesh_dim_names, tuple(dm.shape)),
            "feed_hsdp": dist.batch_feed_slice(hm, 4),
            "feed_data": dist.batch_feed_slice(dm, 4),
            "host": dist.host_local_slice(4),
            "items": dist.shard_list(list(range(5))),
            "arrays0": dist.all_gather_arrays(np.full((1, 2), rank), 0),
            "arrays1": dist.all_gather_arrays(np.full((1, 2), rank), 1),
            "gathered": gathered, "avg": avg, "seed": dist.process_seed(7)}


def test_helpers_over_two_ranks(two_ranks):
    """The JAX semantics over two processes: data ranks feed contiguous
    halves; init times strided; gathers in rank order; means; the seed
    folded per rank. A model group's ranks split their replica's rows (in
    JAX they feed the same rows to a tensor-parallel step; the port's HSDP
    splits by rows)."""
    r0, r1 = (r["helpers"] for r in two_ranks)
    for r, rec in enumerate((r0, r1)):
        assert rec["rank"] == r and rec["count"] == 2
        assert rec["hsdp"] == (("data", "model"), (1, 2))
        assert rec["data"] == (("data",), (2,))
        assert rec["feed_hsdp"] == slice(2 * r, 2 * r + 2)  # one replica, split
        assert rec["feed_data"] == rec["host"] == slice(2 * r, 2 * r + 2)
        assert rec["items"] == list(range(5))[r::2]
        np.testing.assert_array_equal(rec["arrays0"], [[0, 0], [1, 1]])
        np.testing.assert_array_equal(rec["arrays1"], [[[0, 0], [1, 1]]])
        torch.testing.assert_close(rec["avg"][0], torch.full((5,), 0.5), rtol=0, atol=0)
        torch.testing.assert_close(rec["avg"][1], torch.full((2, 2), 5.0), rtol=0, atol=0)
    assert torch.equal(r0["gathered"], torch.cat([torch.zeros(2, 3), torch.ones(2, 3)]))
    assert r1["gathered"] is None
    assert r0["seed"] != r1["seed"]


# ------------------------------------------- forecast and scoring CLIs ----

DIT_KW = dict(in_channels=84, out_channels=84, num_attention_heads=2,
              attention_head_dim=16, num_layers=1, num_single_layers=1,
              num_refiner_layers=1, mlp_ratio=2.0, rope_axes_dim=(4, 6, 6),
              conditioning_tensor_rope_axes_dim=(4, 6, 6),
              conditioning_tensor_in_channels=84)
DCAE_KW = dict(in_channels=89, out_channels=89, latent_channels=84,
               attention_head_dim=4,
               encoder_block_out_channels=(84, 84, 84, 84),
               decoder_block_out_channels=(84, 84, 84, 84),
               encoder_layers_per_block=(1, 1, 1, 1),
               decoder_layers_per_block=(1, 1, 1, 1), static_channels=5)
SCORE_DCAE_KW = dict(in_channels=89, out_channels=89, latent_channels=8,
                     attention_head_dim=4,
                     encoder_block_types=("ResBlock", "ResBlock"),
                     decoder_block_types=("ResBlock", "ResBlock"),
                     encoder_block_out_channels=(8, 16),
                     decoder_block_out_channels=(8, 16),
                     encoder_layers_per_block=(1, 1), decoder_layers_per_block=(1, 1),
                     static_channels=5)
FIELD_TS = [2018010100, 2018010106, 2018010112]
SCORE_W = 8  # longitudes of the scorer's truth
SCORE_TS = [2018010100, 2018010200, 2018010300]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Seeded tiny models of the port written as hub directories, raw
    fields with SST NaNs, and E=3 latent files with a narrow truth."""
    from ladcast_torch import static_data
    from ladcast_torch.config import DCAEConfig, LaDCastDiTConfig
    from ladcast_torch.models import hub
    from ladcast_torch.models.dcae import build_dcae
    from ladcast_torch.models.ladcast_dit import build_dit

    tmp = tmp_path_factory.mktemp("parallel")
    dirs = {}
    for name, kind, cfg, build in (
            ("dit", "dit", LaDCastDiTConfig(**DIT_KW), build_dit),
            ("dcae", "dcae", DCAEConfig(**DCAE_KW), build_dcae),
            ("score_dcae", "dcae", DCAEConfig(**SCORE_DCAE_KW), build_dcae)):
        dirs[name] = str(tmp / name)
        hub.save_pretrained(dirs[name], kind, cfg,
                            build(cfg, "cpu", torch.float32, seed=len(dirs)).state_dict())
    fm, fs = static_data.era5_mean_std()
    rng = np.random.RandomState(0)
    fields = (rng.randn(3, 120, 240, 84) * fs + fm).astype(np.float32)
    fields[:, :40, :40, 82] = np.nan
    era5 = str(tmp / "era5.npz")
    np.savez(era5, fields=fields, timestamps=np.asarray(FIELD_TS, np.int64))
    truth = (rng.randn(4, 120, SCORE_W, 84) * fs + fm).astype(np.float32)
    truth[:, 10:30, 2:5, 82] = np.nan
    score_truth = str(tmp / "truth.npz")
    np.savez(score_truth, fields=truth,
             timestamps=np.asarray(SCORE_TS + [2018010400], np.int64))
    lat_dir = tmp / "latents"
    lat_dir.mkdir()
    for ts in SCORE_TS[:2]:
        np.save(lat_dir / f"latent_{ts}.npy",
                rng.randn(3, 8, 3, 60, SCORE_W // 2).astype(np.float32))
    return dict(tmp=tmp, era5=era5, truth=score_truth, lat_dir=str(lat_dir), **dirs)


def cli_runs_job(module, runs):
    """Each argv of ``runs`` through ``module``'s ``run`` (``pred_rollout``,
    in fp32) or ``main`` (``evaluate_ens``), one after the other in the same
    ranks; returns their results."""
    from ladcast_torch.cli import evaluate_ens, pred_rollout

    if module == "pred_rollout":
        return [pred_rollout.run(pred_rollout.build_parser().parse_args(argv),
                                 compute_dtype="float32") for argv in runs]
    return [evaluate_ens.main(argv) for argv in runs]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _forecast_argv(world, out, *extra):
    return ["--data", world["era5"], "--dit_params", world["dit"],
            "--dcae_params", world["dcae"], "--output_dir", str(world["tmp"] / out),
            "--start_date", "2018-01-01", "--end_date", "2018-01-01T12",
            "--num_samples_per_month", "2", "--ensemble_size", "3",
            "--num_inference_steps", "2", "--return_seq_len", "2",
            "--total_lead_time_hour", "12", "--device", "cpu", "--seed", "5", *extra]


def _score_argv(world, out, *extra):
    return ["--latent_dir", world["lat_dir"], "--truth", world["truth"],
            "--dcae_params", world["score_dcae"], "--step_size_hour", "24",
            "--allow_truth_mean_climatology", "--diagnostics",
            "--output_dir", str(world["tmp"] / out), "--device", "cpu", *extra]


def two_rank_job(forecasts, scores):
    """Every two-rank case of this file in one pair of ranks (a spawn's
    start costs tens of seconds on a busy host): the helpers, the forecasts
    strided (no decode) and member-sharded (with the decode), the scoring
    strided and member-sharded."""
    return {"helpers": helpers_job(),
            "forecasts": cli_runs_job("pred_rollout", forecasts),
            "scores": cli_runs_job("evaluate_ens", scores)}


@pytest.fixture(scope="module")
def two_ranks(world):
    return spawn(two_rank_job, 2, world["tmp"],
                 [_forecast_argv(world, "strided"),
                  _forecast_argv(world, "shard_ensemble", "--shard_ensemble", "--decode")],
                 [_score_argv(world, "scores_strided"),
                  _score_argv(world, "scores_shard_ensemble", "--shard_ensemble")])


@pytest.fixture(scope="module")
def forecasts(world, two_ranks):
    """3 members, two init times: one process with --decode against the
    two ranks' runs."""
    cli_runs_job("pred_rollout", [_forecast_argv(world, "one", "--decode")])
    return {"dir": world["tmp"], "strided": [r["forecasts"][0] for r in two_ranks],
            "shard_ensemble": [r["forecasts"][1] for r in two_ranks]}


@pytest.mark.parametrize("mode", ["strided", "shard_ensemble"])
def test_pred_rollout_over_two_ranks(forecasts, mode):
    """Strided, each rank writes its init time's latent file; with
    --shard_ensemble rank 0 writes both init times' latents and fields from
    2 + 2 members (one padded and discarded). Either way the files equal
    one process's."""
    done = [[r["init_time"] for r in rank if "rollout_s" in r] for rank in forecasts[mode]]
    if mode == "shard_ensemble":
        assert done == [[2018010100, 2018010112]] * 2
        assert all("gather_s" in r for rank in forecasts[mode] for r in rank
                   if "rollout_s" in r)
    else:
        assert done == [[2018010100], [2018010112]]
    one, two = forecasts["dir"] / "one", forecasts["dir"] / mode
    names = sorted(os.listdir(two))
    want = [n for n in sorted(os.listdir(one))
            if mode == "shard_ensemble" or n.endswith(".npy")]
    assert names == want and len(names) == (4 if mode == "shard_ensemble" else 2)
    for name in names:
        a, b = np.load(two / name), np.load(one / name)
        got, ref = (a["fields"], b["fields"]) if name.endswith(".npz") else (a, b)
        assert got.shape == ref.shape and got.shape[0] == 3
        assert _rel(got, ref) <= 1e-5, name


@pytest.fixture(scope="module")
def scores(world, two_ranks):
    """Two init times scored by one process against the two ranks' runs."""
    one = cli_runs_job("evaluate_ens", [_score_argv(world, "scores_one")])[0]
    return {"dir": world["tmp"], "one": one,
            "strided": [r["scores"][0] for r in two_ranks],
            "shard_ensemble": [r["scores"][1] for r in two_ranks]}


@pytest.mark.parametrize("mode", ["strided", "shard_ensemble"])
def test_evaluate_ens_over_two_ranks(scores, mode):
    """Two init times over two ranks (one each), or both on every rank with
    each lead's 3 members decoded 2 + 2 (one padded) and scored on rank 0:
    the merged tables and the summary equal one process's."""
    one, (r0, r1) = scores["one"], scores[mode]
    assert r1["summary"] is None and r0["num_init_times"] == one["num_init_times"] == 2
    scored = [[r["init_time"] for r in rec["records"] if r["scored"]] for rec in (r0, r1)]
    assert scored == ([SCORE_TS[:2], []] if mode == "shard_ensemble"
                      else [[SCORE_TS[0]], [SCORE_TS[1]]])
    for key in ("ens_mean_mse", "crps", "acc", "spread", "rank_hist",
                "spectrum_fc", "spectrum_truth"):
        got = np.load(scores["dir"] / f"scores_{mode}" / f"{key}.npy")
        want = np.load(scores["dir"] / "scores_one" / f"{key}.npy")
        assert got.shape == want.shape and got.shape[0] == 2
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=key)
        for r in (0, 1):
            assert (scores["dir"] / f"scores_{mode}" / f"{key}.rank{r}.npy").exists()
    for var, leads in one["summary"].items():
        for lead, vals in leads.items():
            for k, v in vals.items():
                assert abs(r0["summary"][var][lead][k] - v) <= 1e-6 * max(abs(v), 1e-4)
