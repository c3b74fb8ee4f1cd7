"""The port's monthly-tar ERA5 archives (``data/era5_tar.py``) against the
JAX package's, on the same files: archives written by either package and
read by the other, through tarfile and through the C++ reader, give the
same bits; the split arithmetic, ``read_tar_range``, ``preprocess_batch``,
the transforms and ``open_field_source`` on a tar directory agree."""

import io
import logging
import os
import tarfile

import numpy as np
import pytest
import torch

from ladcast_torch.cli import pred_rollout as t_pred
from ladcast_torch.data import era5_tar as t_tar
from ladcast_torch.data import time_utils as t_time
from ladcast_torch.data import transforms as t_transforms
from ladcast_tpu.cli import pred_rollout as j_pred
from ladcast_tpu.data import era5_tar as j_tar
from ladcast_tpu.data import transforms as j_transforms

# raw members at a small grid: (C, lat, lon) = (7, 9, 8), stored channels
# first as the archive does; 2017-12-31T20 .. 2018-01-01T03 and
# 2018-02-28T22 .. 2018-03-01T01 (four archives, two splits)
STAMPS = ([t_time.add_hours_int(2017123120, h) for h in range(8)]
          + [t_time.add_hours_int(2018022822, h) for h in range(4)])


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The test suite runs files in parallel workers on a shared CPU; two
    intra-op threads per worker keep them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Source:
    """Raw frames (lat, lon, C) with a pole row and a last channel."""

    def __init__(self, seed=0, n=len(STAMPS)):
        self.data = np.random.RandomState(seed).randn(n, 9, 8, 7).astype(np.float32)
        self.ts = STAMPS[:n]

    def frames_at(self, ts_ints):
        return np.stack([self.data[self.ts.index(int(t))] for t in ts_ints])


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """The same frames written as monthly tars by each package."""
    src = _Source()
    out = {}
    for name, mod in (("jax", j_tar), ("torch", t_tar)):
        d = str(tmp_path_factory.mktemp(f"tars_{name}"))
        mod.write_tar_archive(src, src.ts, d)
        out[name] = d
    return src, out


def test_writers_lay_out_the_same_archive(archives):
    _, dirs = archives
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["torch"])) == [
        "2017_12.tar", "2018_01.tar", "2018_02.tar", "2018_03.tar"]
    for n in names:
        with tarfile.open(os.path.join(dirs["jax"], n)) as a, \
                tarfile.open(os.path.join(dirs["torch"], n)) as b:
            ma, mb = a.getmembers(), b.getmembers()
            assert [(m.name, m.size, m.offset_data) for m in ma] == \
                   [(m.name, m.size, m.offset_data) for m in mb]
            for x, y in zip(ma, mb):
                assert a.extractfile(x).read() == b.extractfile(y).read()


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "tarfile"])
def test_read_by_the_other_package_bit_equal(archives, writer, native):
    src, dirs = archives
    want = src.data[:, 1:, :, :-1]  # the pole row cropped, the last channel dropped
    order = [STAMPS[i] for i in (9, 0, 7, 3, 11, 8)]  # across archives, unsorted
    idx = [STAMPS.index(t) for t in order]
    t_src = t_tar.TarFieldSource(dirs[writer], native=native)
    j_src = j_tar.TarFieldSource(dirs[writer], native=native)
    try:
        got, ref = t_src.frames_at(order), j_src.frames_at(order)
        assert got.dtype == np.float32 and got.shape == (6, 8, 8, 6)
        np.testing.assert_array_equal(got, want[idx])
        np.testing.assert_array_equal(got, ref)
        raw = t_tar.TarFieldSource(dirs[writer], crop_south_pole=False,
                                   drop_last_channel=False, native=native)
        np.testing.assert_array_equal(raw.frames_at(order), src.data[idx])
        raw.close()
        assert bool(t_src._native_srcs) == native
        with pytest.raises(KeyError):
            t_src.frames_at([2018010105])  # inside an archive, not in it
    finally:
        t_src.close()
        j_src.close()


def test_split_arithmetic_and_timestamps_match_jax(archives):
    _, dirs = archives
    for split in ("train", "validation", "test", "full", "2018", "2017"):
        assert t_tar.split_year_range(split) == j_tar.split_year_range(split)
        assert t_tar.split_tar_files(dirs["torch"], split) == \
            j_tar.split_tar_files(dirs["torch"], split)
        np.testing.assert_array_equal(
            t_tar.available_timestamps(dirs["torch"], split),
            j_tar.available_timestamps(dirs["jax"], split))
        np.testing.assert_array_equal(t_tar.split_timestamps(STAMPS, split),
                                      j_tar.split_timestamps(STAMPS, split))
    assert list(t_tar.available_timestamps(dirs["torch"], "train")) == STAMPS[:4]
    assert t_tar.split_timestamps is t_time.split_timestamps  # one split table
    with pytest.raises(ValueError):
        t_tar.split_year_range("1900")


def test_read_tar_range_and_preprocess_match_jax(archives):
    src, dirs = archives
    for dh in (1, 3):
        got, ts = t_tar.read_tar_range(dirs["jax"], 2017123121, 2018010103, dh)
        ref, jts = j_tar.read_tar_range(dirs["torch"], 2017123121, 2018010103, dh)
        assert ts == jts
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            got, np.moveaxis(src.data[[STAMPS.index(t) for t in ts]], -1, 1))
    rng = np.random.RandomState(1)
    batch = rng.randn(3, 4, 5, 6).astype(np.float32)
    batch[0, 1, 2, 4] = batch[2, 0, 0, 1] = np.nan
    mean, std = rng.randn(6).astype(np.float32), rng.rand(6).astype(np.float32) + 0.5
    for sst in (4, None):
        (a, ma), (b, mb) = (t_tar.preprocess_batch(batch, mean, std, sst),
                            j_tar.preprocess_batch(batch, mean, std, sst))
        np.testing.assert_array_equal(a, b)
        if sst is None:
            assert ma is None and mb is None
        else:
            np.testing.assert_array_equal(ma, mb)
    x = rng.randn(2, 9, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(t_transforms.crop_south_pole(x),
                                  j_transforms.crop_south_pole(x))
    for lat, lon in ((3, 5), (-2, 11), (0, 0)):
        np.testing.assert_array_equal(
            t_transforms.periodic_roll(torch.from_numpy(x), lat, lon).numpy(),
            np.asarray(j_transforms.periodic_roll(x, lat, lon)))


def test_open_field_source_on_a_tar_directory_matches_jax(archives):
    _, dirs = archives
    for split in (None, "train", "2018"):
        t_src, t_ts = t_pred.open_field_source(dirs["torch"], split)
        j_src, j_ts = j_pred.open_field_source(dirs["torch"], split)
        assert isinstance(t_src, t_tar.TarFieldSource)
        np.testing.assert_array_equal(t_ts, j_ts)
        np.testing.assert_array_equal(t_src.frames_at(t_ts), j_src.frames_at(j_ts))
        t_src.close()
        j_src.close()


def test_native_auto_falls_back_per_archive(tmp_path, caplog):
    """An archive of mixed member sizes cannot be read at a stride: under
    "auto" tarfile serves that archive, with a log line naming it; True
    raises; the other archives stay on the native reader."""
    src = _Source()
    d = str(tmp_path)
    t_tar.write_tar_archive(src, src.ts, d)
    odd = np.zeros((7, 10, 8), np.float32)  # one taller member in 2018_02
    with tarfile.open(os.path.join(d, "2018_02.tar"), "a") as t:
        buf = io.BytesIO()
        np.save(buf, odd)
        info = tarfile.TarInfo("2018-02-27T00.npy")
        info.size = buf.tell()
        buf.seek(0)
        t.addfile(info, buf)
    auto = t_tar.TarFieldSource(d)
    with caplog.at_level(logging.WARNING, logger="ladcast_torch.data.era5_tar"):
        got = auto.frames_at([2018022822, 2017123120])
    assert "2018_02.tar" in caplog.text and "tarfile fallback" in caplog.text
    np.testing.assert_array_equal(
        got, src.data[[STAMPS.index(2018022822), 0]][:, 1:, :, :-1])
    assert auto._native_srcs["2018_02.tar"] is None
    assert auto._native_srcs["2017_12.tar"] is not None
    auto.close()
    strict = t_tar.TarFieldSource(d, native=True)
    with pytest.raises(ValueError, match="mixed member sizes"):
        strict.frames_at([2018022822])
    strict.close()


def test_train_dcae_on_a_tar_directory_matches_the_npz_run(tmp_path):
    """``cli.train_dcae`` on a tar directory trains on its train split and,
    with no ``--val_data``, validates on its validation split: the same
    losses, bit for bit, as the run on the two ``.npz`` bundles of the same
    frames (the archive's members written as chip_smoke.py writes them)."""
    import chip_smoke
    from ladcast_torch.cli import train_dcae as t_dcae_cli
    from tests.test_torch_train_dcae import TINY_CFG, _write_npz

    train, val = str(tmp_path / "train.npz"), str(tmp_path / "val.npz")
    _write_npz(train, 3, 0)  # 2017: the train split
    _write_npz(val, 2, 1, start=2018030100)  # 2018: the validation split
    stamps = [int(t) for p in (train, val) for t in np.load(p)["timestamps"]]
    tars = str(tmp_path / "tars")
    t_tar.write_tar_archive(chip_smoke.RawArchiveSource([train, val], stamps),
                            stamps, tars)
    cfg = {**TINY_CFG, "train": {**TINY_CFG["train"], "batch_size": 2}}
    runs = {}
    for name, argv in (("npz", ["--data", train, "--val_data", val]),
                       ("tar", ["--data", tars])):
        res = t_dcae_cli.run(cfg, t_dcae_cli.build_parser().parse_args(
            [*argv, "--num_steps", "2", "--log_every", "1",
             "--output_dir", str(tmp_path / name), "--device", "cpu"]))
        runs[name] = ([(h["loss"], h["grad_norm"]) for h in res["history"]],
                      [v["val_loss"] for v in res["validations"]])
    assert len(runs["tar"][0]) == 2 and len(runs["tar"][1]) == 1
    assert runs["tar"] == runs["npz"]
