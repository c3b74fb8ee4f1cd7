"""ctypes bindings of the C++ shard reader (the port of
``ladcast_tpu/data/native_reader.py``).

The reader is ``ladcast_torch/native/shard_reader.cpp``, which ships with
the package. It is compiled with g++ at first use into the build root of
``ops/_build.py`` (``build/ladcast_torch/`` in a checkout, torch's
extension cache for an installed package), under a directory named by a
hash of the source and the flags; the library is written under a
temporary name and renamed, so that processes building at once each load
a whole file. A missing g++ or a failed build raises ``RuntimeError``.

``NpyShardSource`` serves latent frames from ``.npy`` shards and
``TarNpyMemberSource`` field frames from monthly tars of equal-size
``.npy`` members: the npy headers are parsed here, the reads run on the
library's thread pool with pread, without the GIL. Both return numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import shutil
import subprocess
import tarfile
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().parent.parent / "native" / "shard_reader.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_I64P = ctypes.POINTER(ctypes.c_int64)


def library_path() -> Path:
    """Where the built library lives: a directory named by a hash of the
    source and the flags under the build root of ``ops/_build.py``."""
    from ladcast_torch.ops._build import _build_root

    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return _build_root() / "native" / h.hexdigest()[:16] / "libshard_reader.so"


def _build(lib: Path) -> None:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native shard reader cannot be built")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {_SOURCE.name} failed (rc {r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all of it or none


def load_library() -> ctypes.CDLL:
    """The loaded reader, built first if needed."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.is_file():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.sr_open.restype = ctypes.c_void_p
        lib.sr_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                _I64P, _I64P, ctypes.c_int64, ctypes.c_int]
        lib.sr_open2.restype = ctypes.c_void_p
        lib.sr_open2.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                 _I64P, _I64P, _I64P, ctypes.c_int64, ctypes.c_int]
        lib.sr_num_frames.restype = ctypes.c_int64
        lib.sr_num_frames.argtypes = [ctypes.c_void_p]
        lib.sr_read.restype = ctypes.c_int
        lib.sr_read.argtypes = [ctypes.c_void_p, _I64P, ctypes.c_int,
                                ctypes.c_char_p]
        lib.sr_prefetch.restype = None
        lib.sr_prefetch.argtypes = [ctypes.c_void_p, _I64P, ctypes.c_int]
        lib.sr_close.restype = None
        lib.sr_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _read_header(f, origin: str) -> Tuple[int, tuple, np.dtype]:
    version = np.lib.format.read_magic(f)
    if version >= (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    if fortran:
        raise ValueError(f"{origin}: fortran-order npy unsupported")
    return f.tell(), shape, dtype


def parse_npy_header(path: str) -> Tuple[int, tuple, np.dtype]:
    """(data offset, shape, dtype) of an uncompressed ``.npy`` file."""
    with open(path, "rb") as f:
        return _read_header(f, path)


def parse_npy_header_bytes(buf: bytes, origin: str = "<buffer>"
                           ) -> Tuple[int, tuple, np.dtype]:
    """(data offset, shape, dtype) of an in-memory ``.npy`` prefix."""
    return _read_header(io.BytesIO(buf), origin)


def _c_paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


def _c_i64(values):
    return (ctypes.c_int64 * len(values))(*values)


class _Reader:
    """A handle of the library, its frame layout, and the reads."""

    frame_shape: tuple
    dtype: np.dtype
    _h = None

    def _open(self, lib, h, what):
        if not h:
            raise OSError(f"the native reader could not open {what}")
        self._lib, self._h = lib, h
        self._total = int(lib.sr_num_frames(h))

    def frames(self, idx) -> np.ndarray:
        """Frames at global indices ``idx``, (len(idx), *frame_shape)."""
        idx = np.ascontiguousarray(np.atleast_1d(np.asarray(idx, np.int64)))
        if self._h is None:
            raise ValueError("read from a closed source")
        if idx.size and (idx.min() < 0 or idx.max() >= self._total):
            raise IndexError(f"frame index out of [0, {self._total})")
        out = np.empty((idx.size, *self.frame_shape), self.dtype)
        rc = self._lib.sr_read(self._h, idx.ctypes.data_as(_I64P), idx.size,
                               out.ctypes.data_as(ctypes.c_char_p))
        if rc != 0:
            raise OSError("native read failed")
        return out

    def close(self):
        if self._h is not None:
            self._lib.sr_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class TarNpyMemberSource(_Reader):
    """Random access over tar archives of equal-size ``.npy`` members (the
    monthly ERA5 layout). Such a tar is a strided container: member i's
    data sits at ``first data offset + i * stride``, stride = the 512-byte
    header plus the payload padded to 512. One pass over each archive's
    headers builds the index; an archive of mixed sizes or strides raises
    ValueError (the caller reads it with tarfile instead)."""

    def __init__(self, tar_paths: Sequence[str], num_threads: int = 4):
        lib = load_library()
        counts, data_offsets, strides = [], [], []
        self.member_names: list = []
        frame_shape = dtype = None
        for p in tar_paths:
            with tarfile.open(p, "r") as tf:
                infos = [m for m in tf.getmembers() if m.name.endswith(".npy")]
            if not infos:
                raise ValueError(f"{p}: no .npy members")
            infos.sort(key=lambda m: m.offset_data)
            offs = np.asarray([m.offset_data for m in infos], np.int64)
            if len({m.size for m in infos}) != 1:
                raise ValueError(f"{p}: mixed member sizes")
            d = np.diff(offs)
            if d.size and (d != d[0]).any():
                raise ValueError(f"{p}: non-uniform member stride")
            stride = int(d[0]) if d.size else -(-infos[0].size // 512) * 512 + 512
            with open(p, "rb") as f:
                f.seek(int(offs[0]))
                hdr, shape, dt = parse_npy_header_bytes(
                    f.read(min(infos[0].size, 4096)), p)
            if frame_shape is None:
                frame_shape, dtype = shape, dt
            elif shape != frame_shape or dt != dtype:
                raise ValueError(f"{p}: member layout mismatch")
            counts.append(len(infos))
            data_offsets.append(int(offs[0]) + hdr)
            strides.append(stride)
            self.member_names.extend(m.name for m in infos)
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self.frame_bytes = int(np.prod(frame_shape)) * self.dtype.itemsize
        self._open(lib, lib.sr_open2(_c_paths(tar_paths), len(tar_paths),
                                     _c_i64(counts), _c_i64(data_offsets),
                                     _c_i64(strides), self.frame_bytes,
                                     num_threads), list(tar_paths))
        self.index_by_name = {n: i for i, n in enumerate(self.member_names)}

    def __len__(self):
        return len(self.member_names)


class NpyShardSource(_Reader):
    """A latent source over ``.npy`` shards, each (time, h, w, C), with the
    timestamps of all shards in order (the protocol of
    ``ArrayLatentSource``, plus :meth:`prefetch`)."""

    def __init__(self, paths: Sequence[str], timestamps: Sequence[int],
                 num_threads: int = 4):
        lib = load_library()
        offsets, counts = [], []
        shape_tail = dtype = None
        for p in paths:
            off, shape, dt = parse_npy_header(p)
            if shape_tail is None:
                shape_tail, dtype = shape[1:], dt
            elif shape[1:] != shape_tail or dt != dtype:
                raise ValueError(f"shard {p}: layout {shape} {dt} differs from "
                                 f"(*, {shape_tail}) {dtype}")
            offsets.append(off)
            counts.append(shape[0])
        self.frame_shape = tuple(shape_tail)
        self.dtype = np.dtype(dtype)
        self.frame_bytes = int(np.prod(shape_tail)) * self.dtype.itemsize
        self._open(lib, lib.sr_open(_c_paths(paths), len(paths), _c_i64(counts),
                                    _c_i64(offsets), self.frame_bytes,
                                    num_threads), list(paths))
        if self._total != len(timestamps):
            self.close()
            raise ValueError(f"{self._total} frames in the shards, "
                             f"{len(timestamps)} timestamps")
        self.timestamps = np.asarray(timestamps, np.int64)

    def __len__(self):
        return int(self.timestamps.shape[0])

    def prefetch(self, idx) -> None:
        """Ask the page cache to read these frames ahead (no-op past the
        end)."""
        idx = np.ascontiguousarray(np.atleast_1d(np.asarray(idx, np.int64)))
        if self._h is not None:
            self._lib.sr_prefetch(self._h, idx.ctypes.data_as(_I64P), idx.size)

    def timestamp(self, idx: int) -> int:
        return int(self.timestamps[idx])
