"""Process-group helpers (the port of ``ladcast_tpu/parallel/dist.py``).

The JAX package runs one process per host, with a mesh over that host's
devices; the port runs one process per card, as ``torchrun
--nproc_per_node N`` launches it. :func:`initialize` forms the process group
from torchrun's environment (``env://``) or from its arguments; without a
``WORLD_SIZE`` above 1 and without an ``init_method`` it is a no-op, and
every helper here then degrades to its single-process meaning: rank 0 of 1,
no barrier, gathers that return their input.

``make_global_batch`` has no counterpart: a rank's batch is its own rows
(:func:`batch_feed_slice`), and the parameters' sharding, not the batch's,
decides what is communicated (``parallel.sharding_rules``).

Collectives run on the group's backend: NCCL moves CUDA tensors on the card,
gloo moves CPU tensors, so a CUDA tensor crosses to the host and back under
gloo (the two-process run on one card).
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as tdist

from ladcast_torch import resolve_device


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device="cuda") -> None:
    """Form the default process group, once.

    A no-op when the group exists, or in a single process: no
    ``init_method`` and a world size (the argument, else ``WORLD_SIZE``) of
    at most 1. Otherwise ``init_method`` defaults to ``env://`` (torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT``), the rank to ``RANK``, and the backend
    to ``nccl`` when ``device`` is CUDA and ``gloo`` on the CPU. Under NCCL
    the process takes the card ``cuda:LOCAL_RANK``. A group that cannot be
    formed raises (``init_process_group``'s own error)."""
    if tdist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if init_method is None and world_size <= 1:
        return
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        resolve_device("cuda")  # raises without CUDA
        torch.cuda.set_device(local_rank())
    tdist.init_process_group(backend, init_method=init_method or "env://",
                             world_size=world_size, rank=rank)


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def process_count() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    """``LOCAL_RANK`` (torchrun's), else the rank."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def local_device(device) -> torch.device:
    """The card of this process: ``cuda:LOCAL_RANK`` for a CUDA device under
    an NCCL group (set by :func:`initialize`), else ``device`` as given with
    CUDA's current index made explicit."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", torch.cuda.current_device())


def collective_device(group=None) -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, the host under gloo."""
    if tdist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_seed(seed: int) -> int:
    """Per-process decorrelation of an integer seed: the rank folded into
    it (the JAX package's ``fold_process_key``); the seed itself in a
    single process."""
    if process_count() == 1:
        return int(seed)
    state = np.random.SeedSequence((int(seed), process_index())).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def all_gather_arrays(x: np.ndarray, axis: int = 0) -> np.ndarray:
    """Host-side all-gather of per-process numpy arrays of one shape: on
    ``axis`` 0 the ranks' arrays concatenated, on another axis stacked
    there on a new axis, as the JAX function does. One process: ``x``."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    parts: List[Any] = [None] * process_count()
    tdist.all_gather_object(parts, x)
    if axis == 0:
        return np.concatenate(parts, axis=0)
    return np.stack(parts, axis=axis)


def gather_to_rank0(t: torch.Tensor, group=None) -> Optional[torch.Tensor]:
    """Concatenate every rank's ``t`` (one shape on every rank) on dim 0 on
    rank 0, on ``t``'s device; the other ranks get None. One process:
    ``t``."""
    if process_count() == 1:
        return t
    dev = collective_device(group)
    x = t.detach().to(dev).contiguous()
    parts = ([torch.empty_like(x) for _ in range(tdist.get_world_size(group))]
             if process_index() == 0 else None)
    tdist.gather(x, parts, dst=0, group=group)
    if parts is None:
        return None
    return torch.cat(parts).to(t.device)


def all_reduce_mean_(tensors: List[torch.Tensor], group=None,
                     bucket_bytes: int = 64 * 2**20) -> None:
    """Average a list of tensors over the group's ranks, in place: the
    tensors of one dtype and device are packed into flat buckets of about
    ``bucket_bytes``, each summed by one all-reduce and divided by the
    group's size (gloo has no averaging reduction). A no-op without a
    group."""
    if not is_initialized():
        return
    n = tdist.get_world_size(group)
    dev = collective_device(group)
    buckets, cur, size = [], [], 0
    for t in tensors:
        if cur and (t.dtype != cur[0].dtype or t.device != cur[0].device
                    or size + t.numel() * t.element_size() > bucket_bytes):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += t.numel() * t.element_size()
    if cur:
        buckets.append(cur)
    for bucket in buckets:
        flat = torch.cat([t.reshape(-1) for t in bucket]).to(dev)
        tdist.all_reduce(flat, group=group)
        flat.div_(n)
        flat = flat.to(bucket[0].device)
        i = 0
        for t in bucket:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()


def full_state_dict(module: torch.nn.Module) -> dict:
    """The module's whole state dict on the host: on rank 0 every tensor in
    full, gathered from its shards, on the other ranks an empty dict. It is
    a collective when the module is sharded (``fully_shard``), so every
    rank calls it, outside any rank guard. One process: the state dict,
    detached, on the host."""
    if not is_initialized():
        return {k: v.detach().cpu() for k, v in module.state_dict().items()}
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        get_model_state_dict,
    )

    return get_model_state_dict(
        module, options=StateDictOptions(full_state_dict=True, cpu_offload=True))


def host_local_slice(global_batch_size: int) -> slice:
    """The contiguous rows of a seeded global batch order that this process
    reads (every process computes the same order; each reads its slice)."""
    n, r = process_count(), process_index()
    per = global_batch_size // n
    assert per * n == global_batch_size, (global_batch_size, n)
    return slice(r * per, (r + 1) * per)


def _model_size(mesh) -> int:
    return mesh["model"].size() if "model" in mesh.mesh_dim_names else 1


def model_rows_split(mesh, global_batch_size: int) -> bool:
    """Whether the ranks of a ``model`` group split their data replica's
    rows of the global batch: where the mesh has a model axis of more than
    one rank and the replica's rows divide over it."""
    if mesh is None:
        return False
    m = _model_size(mesh)
    return m > 1 and (global_batch_size // mesh["data"].size()) % m == 0


def batch_feed_slice(mesh, global_batch_size: int, announce: bool = False) -> slice:
    """The rows of a seeded global batch that this process feeds under
    ``mesh``: the ``data`` axis splits the batch into replicas' rows, and
    the ranks of a ``model`` group (HSDP) split their replica's rows where
    they divide (:func:`model_rows_split`); where they do not, every rank of
    the group feeds the replica's rows and repeats its compute, which
    ``announce`` prints once, from the group's first rank of the first
    replica. Without a mesh (one process): every row. (In the JAX package
    the ``model`` axis is tensor parallelism: its ranks share the rows and
    split each product.)"""
    if mesh is None:
        return slice(0, global_batch_size)
    n = mesh["data"].size()
    d = mesh.get_local_rank("data")
    per = global_batch_size // n
    assert per * n == global_batch_size, (global_batch_size, n)
    m = _model_size(mesh)
    if model_rows_split(mesh, global_batch_size):
        k, rows = mesh.get_local_rank("model"), per // m
        return slice(d * per + k * rows, d * per + (k + 1) * rows)
    if m > 1 and announce and d == 0 and mesh.get_local_rank("model") == 0:
        print(f"the model axis repeats the compute: the {per} rows of a data "
              f"replica do not divide over its {m} model ranks, so each of "
              f"them feeds all {per} (HSDP splits the memory only)", flush=True)
    return slice(d * per, (d + 1) * per)


def shard_list(items: List[Any]) -> List[Any]:
    """Strided split of host-side work items over the processes."""
    return list(items[process_index()::process_count()])


def barrier(name: str = "barrier") -> None:
    """Every rank waits here for the others; a no-op in one process."""
    if process_count() == 1:
        return
    tdist.barrier()
