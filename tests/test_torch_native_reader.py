"""The port's C++ shard reader (``data/native_reader.py`` over
``ladcast_torch/native/shard_reader.cpp``, built with g++ at first use) and its
latent sources against the JAX package's on the same files: the npy
header parsers, ``NpyShardSource`` and ``TarNpyMemberSource``;
``ShardedLatentSource`` against numpy; ``cli.train_ar.load_latent_source``
under each ``--reader``; and ``batch_iterator``'s batches against JAX's,
with its readahead through the source's ``prefetch``."""

import os
import threading
from pathlib import Path

import numpy as np
import pytest

from ladcast_torch.cli import train_ar as t_cli
from ladcast_torch.data import era5_tar as t_tar
from ladcast_torch.data import latent_dataset as t_ld
from ladcast_torch.data import native_reader as t_nr
from ladcast_torch.data.time_utils import add_hours_int
from ladcast_torch.ops import _build
from ladcast_tpu.data import latent_dataset as j_ld
from ladcast_tpu.data import native_reader as j_nr

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three .npy shards (v1 and v2 headers) of (time, 3, 4, 2) latents and
    the directory layout train_ar reads (timestamps.npy beside them)."""
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.RandomState(0)
    arrays = [rng.randn(n, 3, 4, 2).astype(np.float32) for n in (11, 6, 13)]
    paths = []
    for i, a in enumerate(arrays):
        p = str(d / f"shard{i}.npy")
        if i == 1:  # a version 2.0 header
            with open(p, "wb") as f:
                np.lib.format.write_array(f, a, version=(2, 0))
        else:
            np.save(p, a)
        paths.append(p)
    full = np.concatenate(arrays)
    ts = np.asarray([add_hours_int(2018010100, i) for i in range(len(full))],
                    np.int64)
    np.save(str(d / "timestamps.npy"), ts)
    return dict(dir=str(d), paths=paths, full=full, ts=ts)


def test_library_is_the_ports_own_build():
    path = t_nr.library_path()
    assert path.parent.parent == _build._build_root() / "native"
    assert t_nr._SOURCE == ROOT / "ladcast_torch" / "native" / "shard_reader.cpp"
    lib = t_nr.load_library()
    assert t_nr.load_library() is lib and path.is_file()
    assert Path(lib._name) == path


def test_concurrent_builds_each_load_a_whole_library(tmp_path, monkeypatch):
    """Builds racing on one path (threads here, processes in a parallel
    test run): each writes its own temporary file and renames it, so every
    loader finds a whole library."""
    lib = tmp_path / "h" / "libshard_reader.so"
    errors = []

    def build():
        try:
            t_nr._build(lib)
            import ctypes

            ctypes.CDLL(str(lib)).sr_num_frames
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert sorted(p.name for p in lib.parent.iterdir()) == ["libshard_reader.so"]
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="not found"):
        t_nr._build(tmp_path / "x" / "libshard_reader.so")


def test_header_parsers_match_jax(shards):
    for p in shards["paths"]:
        assert t_nr.parse_npy_header(p) == j_nr.parse_npy_header(p)
        with open(p, "rb") as f:
            head = f.read(4096)
        assert t_nr.parse_npy_header_bytes(head, p) == j_nr.parse_npy_header_bytes(head, p)
    fortran = np.asfortranarray(np.zeros((3, 4), np.float32))
    p = os.path.join(shards["dir"], "..", "fortran.npy")
    np.save(p, fortran)
    with pytest.raises(ValueError, match="fortran"):
        t_nr.parse_npy_header(p)


def test_npy_shard_source_matches_jax_and_numpy(shards):
    full, ts = shards["full"], shards["ts"]
    src = t_nr.NpyShardSource(shards["paths"], ts, num_threads=3)
    ref = j_nr.NpyShardSource(shards["paths"], ts, num_threads=3)
    try:
        assert len(src) == len(full) == 30 and src.frame_shape == (3, 4, 2)
        idx = np.asarray([0, 10, 11, 16, 17, 29, 5, 11])  # across the shards
        np.testing.assert_array_equal(src.frames(idx), full[idx])
        np.testing.assert_array_equal(src.frames(idx), ref.frames(idx))
        np.testing.assert_array_equal(src.frames(np.arange(30)), full)
        assert src.frames([]).shape == (0, 3, 4, 2)
        src.prefetch(idx)
        src.prefetch([29, 99])  # past the end: a no-op
        assert src.timestamp(17) == ref.timestamp(17) == int(ts[17])
        with pytest.raises(IndexError):
            src.frames([30])
        with pytest.raises(ValueError, match="timestamps"):
            t_nr.NpyShardSource(shards["paths"], ts[:-1])
    finally:
        src.close()
        ref.close()
    with pytest.raises(ValueError, match="closed"):
        src.frames([0])


def test_tar_member_source_matches_jax(tmp_path):
    rng = np.random.RandomState(2)

    class Src:
        data = rng.randn(30, 5, 6, 3).astype(np.float32)
        ts = [add_hours_int(2018013112, h) for h in range(30)]

        def frames_at(self, t):
            return self.data[[self.ts.index(int(x)) for x in t]]

    t_tar.write_tar_archive(Src(), Src.ts, str(tmp_path))
    tars = sorted(str(p) for p in tmp_path.glob("*.tar"))
    assert len(tars) == 2
    src = t_nr.TarNpyMemberSource(tars, num_threads=2)
    ref = j_nr.TarNpyMemberSource(tars, num_threads=2)
    try:
        assert src.member_names == ref.member_names and len(src) == 30
        assert src.index_by_name == ref.index_by_name
        assert (src.frame_shape, src.dtype) == ((3, 5, 6), np.float32)
        idx = np.asarray([29, 0, 12, 11, 13])
        np.testing.assert_array_equal(src.frames(idx), ref.frames(idx))
        np.testing.assert_array_equal(src.frames(idx),
                                      np.moveaxis(Src.data[idx], -1, 1))
    finally:
        src.close()
        ref.close()


def test_sharded_latent_source_matches_numpy(shards):
    full, ts = shards["full"], shards["ts"]
    src = t_ld.ShardedLatentSource(shards["paths"], ts)
    ref = j_ld.ShardedLatentSource(shards["paths"], ts)
    assert len(src) == 30 and src.frame_shape == (3, 4, 2)
    idx = np.asarray([16, 0, 29, 11, 10, 17])
    np.testing.assert_array_equal(src.frames(idx), full[idx])
    np.testing.assert_array_equal(src.frames(idx), ref.frames(idx))
    np.testing.assert_array_equal(src.frames(3), full[[3]])
    assert src.timestamp(11) == int(ts[11])
    with pytest.raises(IndexError):
        src.frames([-1])
    with pytest.raises(ValueError, match="timestamps"):
        t_ld.ShardedLatentSource(shards["paths"], ts[:5])


def test_load_latent_source_readers(shards, monkeypatch, capsys):
    d, full = shards["dir"], shards["full"]
    native = t_cli.load_latent_source(d, "native")
    assert isinstance(native, t_nr.NpyShardSource)
    mmap = t_cli.load_latent_source(d, "mmap")
    assert isinstance(mmap, t_ld.ShardedLatentSource)
    auto = t_cli.load_latent_source(d)
    assert isinstance(auto, t_nr.NpyShardSource)
    idx = np.arange(30)[::-1]
    for src in (native, mmap, auto):
        np.testing.assert_array_equal(src.frames(idx), full[idx])
    native.close()
    auto.close()

    # a library that cannot be built: native raises, auto says so once and
    # reads with mmap
    def no_build():
        raise RuntimeError("g++ not found: the native shard reader cannot be built")

    monkeypatch.setattr(t_nr, "load_library", no_build)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        t_cli.load_latent_source(d, "native")
    capsys.readouterr()
    fallback = t_cli.load_latent_source(d, "auto")
    assert isinstance(fallback, t_ld.ShardedLatentSource)
    assert capsys.readouterr().out.count("falling back to numpy mmap") == 1
    with pytest.raises(ValueError, match="reader"):
        t_cli.load_latent_source(d, "zarr")


class _Spy:
    """A source that records what it was asked to read ahead."""

    def __init__(self, src):
        self.src, self.asked = src, []

    def __len__(self):
        return len(self.src)

    def frames(self, idx):
        return self.src.frames(idx)

    def timestamp(self, i):
        return self.src.timestamp(i)

    def prefetch(self, idx):
        self.asked.append(np.asarray(idx))
        self.src.prefetch(idx)


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "in_order"])
def test_batch_iterator_matches_jax_and_reads_ahead(shards, shuffle):
    ts = shards["ts"]
    mean = np.linspace(-0.5, 0.5, 2).astype(np.float32)
    std = np.asarray([1.5, 0.5], np.float32)
    spy = _Spy(t_nr.NpyShardSource(shards["paths"], ts))
    t_ds = t_ld.ARLatentDataset(spy, t_ld.ARWindowConfig(1, 2, 3, 1), mean, std)
    j_ds = j_ld.ARLatentDataset(j_nr.NpyShardSource(shards["paths"], ts),
                                j_ld.ARWindowConfig(1, 2, 3, 1), mean=mean, std=std)
    assert len(t_ds) == len(j_ds) == 24
    got = list(t_ld.batch_iterator(t_ds, 5, shuffle=shuffle, seed=3,
                                   num_push_forward_steps=2))
    want = list(j_ld.batch_iterator(j_ds, 5, shuffle=shuffle, seed=3,
                                    num_push_forward_steps=2))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # before each batch but the last, the frames of the next one
    order = (np.random.RandomState(3).permutation(24) if shuffle else np.arange(24))
    assert len(spy.asked) == 3
    for k, asked in enumerate(spy.asked):
        frames = set()
        for i in order[5 * (k + 1):5 * (k + 2)]:
            a, b = t_ds._window_idx(int(i))
            frames.update(a.tolist() + b.tolist())
        assert asked.tolist() == sorted(frames)
    spy.src.close()
