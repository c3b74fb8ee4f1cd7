"""Build and load the port's CUDA kernels.

Each ``ladcast_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use on a CUDA tensor (or ahead of it, through
:func:`build_all`), one ``nvcc`` per source, all started together, into
``<root>/<hash of the sources and flags>/``. The root is
``build/ladcast_torch/`` at the top of the checkout when the package runs
from one (git-ignored there), and otherwise, for an installed package,
``ladcast_torch/`` under torch's per-user extension cache
(``$TORCH_EXTENSIONS_DIR``, by default ``~/.cache/torch_extensions``). A
finished library is reused; a changed source gets a new directory. nvcc
runs with ``-Xptxas -v``; its output (each kernel's registers, shared
memory and spills) is kept beside the library as ``lib<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_CHECKOUT = Path(__file__).resolve().parents[2]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """{library name: source path} for every kernel source."""
    return {p.stem: p for p in sorted(_CSRC.glob("*.cu"))}


def _build_root() -> Path:
    if (_CHECKOUT / "pyproject.toml").is_file():
        return _CHECKOUT / "build" / "ladcast_torch"
    from torch.utils.cpp_extension import get_default_build_root

    cache = os.environ.get("TORCH_EXTENSIONS_DIR") or get_default_build_root()
    return Path(cache) / "ladcast_torch"


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _build_root() / h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_all() -> Dict[str, Path]:
    """Compile every source that has no library yet, all in parallel.
    Returns {name: library path}. Raises with nvcc's output on failure."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in sources()}
    todo = {n: p for n, p in libs.items() if not p.exists()}
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(sources()[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failures = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc rc {proc.returncode})\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return libs


def nvcc_dir() -> Path:
    """The directory of the nvcc that builds the kernels (its toolkit's
    ``cuobjdump`` sits beside it)."""
    return Path(_nvcc()).parent


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _loaded[name] = lib
    return lib
