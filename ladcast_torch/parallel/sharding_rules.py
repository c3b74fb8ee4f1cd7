"""How the trainers' models are spread over a mesh: FSDP in place of the
JAX package's tensor parallelism and ZeRO (``ladcast_tpu/parallel/
sharding_rules.py``).

The JAX package annotates each DiT parameter with a ``PartitionSpec``
(Megatron column / row splits over a ``model`` axis) and lets GSPMD insert
the collectives; with ZeRO it also shards the optimizer and EMA mirrors
over every axis. The port has no per-parameter specs: FSDP2's
``fully_shard`` of each DiT block and of the root shards every parameter
on its first dimension, all-gathers a unit's parameters for its forward
and its backward, and reduce-scatters its gradients (:func:`shard_dit`). So
this module has no twin in numbers: what each rank holds differs from the
JAX layout, the step's function does not.
The regimes (:func:`dit_regime`):

  * ``single``: no mesh (one process without a process group);
  * ``ddp``: a mesh of data replicas only, without ``zero``: nothing is
    sharded, every rank holds the whole model, and the trainers average
    the gradients with an explicit bucketed all-reduce
    (``dist.all_reduce_mean_``) rather than a ``DistributedDataParallel``
    wrapper, because their steps call the model through
    ``torch.func.functional_call``, not through a wrapper's forward;
  * ``fsdp``: ``zero`` on a data-only mesh: the parameters, their
    gradients, the AdamW moments and the EMA are sharded over ``data``;
  * ``hsdp``: a ``model`` axis of more than one rank: the ``data`` dim
    replicates and the ``model`` dim shards (HSDP), so the ``model`` axis
    carries the memory split that tensor parallelism and ZeRO carried in
    JAX. The compute splits by rows instead of by products: where a data
    replica's rows divide over its model group, each rank of the group
    feeds rows / model of them (``dist.batch_feed_slice``), and the
    reduce-scatter over ``model`` and the all-reduce over ``data`` average
    the gradients over every rank, the global batch's mean. Where they do
    not divide (``configs/ladcast_1p6b.yaml``'s batch 4 over 8 ranks), each
    rank of the group feeds the replica's rows and repeats its forward and
    backward, which ``train_ar`` prints once; ``--mesh data=-1 --zero``
    (FSDP, each rank its own rows) avoids it.

Every regime takes the gradients with ``loss.backward()``
(``trainer_ar.reduced_grads``), which fires FSDP's reduce-scatter.

The parameters stay fp32 (the masters). FSDP cannot see through the
step's ``functional_call`` casts, so the bf16 copy each forward computes
with is made by ``MixedPrecisionPolicy(param_dtype=compute dtype)`` before
the all-gather: the same rounding of the same fp32 values. The gradients
reach the fp32 shards through ``reduce_dtype`` fp32, as the casts'
backward brought them to the fp32 masters; no input is cast
(``cast_forward_inputs=False``), so the fp32 islands of the model stay
fp32. On one rank a step under FSDP gives the single device's bits. With
push-forward (more than one DiT call a step) a unit sums the calls' bf16
gradients before its fp32 reduce-scatter, where one device sums them in
fp32: the same step to bf16 rounding.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ladcast_torch.parallel import dist


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage, outside autograd),
    else ``t``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    with torch.no_grad():
        return t.to_local()


def _axis(mesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh[name].size() if name in names else 1


def check_mesh(mesh, model_axis: bool = True) -> None:
    """A trainer's mesh: a ``data`` axis, and no axis of more than one
    rank besides ``data`` and (where ``model_axis``) ``model``."""
    if mesh is None:
        return
    names = mesh.mesh_dim_names or ()
    if "data" not in names:
        raise ValueError(f"mesh {dict(zip(names, mesh.shape))} must include a "
                         f"'data' axis")
    known = ("data", "model") if model_axis else ("data",)
    extra = {n: mesh[n].size() for n in names if n not in known and mesh[n].size() > 1}
    if extra:
        raise ValueError(f"mesh axes {extra}: only {known} can split this model")


def dit_regime(mesh, zero: bool) -> str:
    if mesh is None:
        return "single"
    if _axis(mesh, "model") > 1:
        return "hsdp"
    return "fsdp" if zero else "ddp"


def norm_group(mesh, regime: str):
    """The process group over which a gradient's shards add up to the whole
    (the sum of squares of the global norm is all-reduced over it); None
    where every rank holds whole gradients."""
    if regime == "fsdp":
        return mesh["data"].get_group()
    if regime == "hsdp":
        return mesh["model"].get_group()
    return None


def broadcast_params(model: nn.Module) -> None:
    """Rank 0's parameters on every rank (the replicas of DDP start equal)."""
    if not dist.is_initialized():
        return
    import torch.distributed as tdist

    dev = dist.collective_device()
    with torch.no_grad():
        for p in model.parameters():
            x = p.detach().to(dev)
            tdist.broadcast(x, src=0)
            p.copy_(x)


def shard_dit(model: nn.Module, mesh, zero: bool,
              compute_dtype: str = "bfloat16") -> str:
    """Spread the DiT over ``mesh`` in place; returns the regime
    (:func:`dit_regime`). Under FSDP and HSDP each dual- and single-stream
    block is an FSDP unit, and the root holds the rest (the embedders, the
    refiner, the head): a block's parameters are gathered for its forward
    and its backward only, and its gradients reduce-scattered as its
    backward ends. With ``cfg.remat`` each block checkpoints itself inside
    its unit (the composable ``checkpoint``, applied before
    ``fully_shard``), so its recompute runs on the parameters its unit
    gathered for the backward. A unit sums the gradient of each of its
    inputs before passing it on; the model gives each block its own copy
    of the embedding that every block reads (``temb``), so the sums are
    the single device's, term for term, and one rank gives its bits."""
    check_mesh(mesh)
    regime = dit_regime(mesh, zero)
    if regime == "ddp":
        broadcast_params(model)
    if regime not in ("fsdp", "hsdp"):
        return regime
    from torch.distributed._composable import checkpoint
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

    # HSDP shards over (data, model), replicating over data; FSDP over data
    shard_mesh = mesh["data", "model"] if regime == "hsdp" else mesh["data"]
    mp = MixedPrecisionPolicy(param_dtype=getattr(torch, compute_dtype),
                              reduce_dtype=torch.float32, cast_forward_inputs=False)
    for block in [*model.transformer_blocks, *model.single_transformer_blocks]:
        if model.cfg.remat:
            checkpoint(block)
        fully_shard(block, mesh=shard_mesh, mp_policy=mp)
    fully_shard(model, mesh=shard_mesh, mp_policy=mp)
    return regime


def shard_dcae(model: nn.Module, mesh) -> str:
    """The DCAE is data-parallel only (the JAX CLI's 1-D ``data`` mesh):
    rank 0's parameters are broadcast, nothing is sharded, and the trainer
    averages the gradients with ``dist.all_reduce_mean_`` (no DDP
    wrapper). Returns the regime, ``single`` or ``ddp``."""
    check_mesh(mesh, model_axis=False)
    if mesh is None:
        return "single"
    broadcast_params(model)
    return "ddp"


def full_tensors(shards: Sequence[torch.Tensor],
                 params: Sequence[torch.Tensor]) -> List[Optional[torch.Tensor]]:
    """The whole tensors of ``shards`` (local shards laid out as their
    ``params``: the AdamW moments, the EMA), on the host: gathered where
    the param is a DTensor (a collective: every rank calls it), and
    returned on rank 0 only (None on the others)."""
    from torch.distributed.tensor import DTensor

    rank0 = dist.process_index() == 0
    out = []
    for s, p in zip(shards, params):
        if isinstance(p, DTensor):
            s = DTensor.from_local(s, p.device_mesh, p.placements, shape=p.shape,
                                   stride=p.stride()).full_tensor()
        out.append(s.detach().cpu() if rank0 else None)
    return out


def load_full_(shards: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               fulls: Optional[Sequence[torch.Tensor]]) -> None:
    """Copy whole tensors, read on rank 0 (``fulls``; None on the other
    ranks), into every rank's ``shards``: each DTensor's rows scattered
    from rank 0, each replicated tensor broadcast."""
    import torch.distributed as tdist
    from torch.distributed.tensor import DTensor, distribute_tensor

    rank0 = dist.process_index() == 0
    dev = dist.collective_device()
    with torch.no_grad():
        for i, (s, p) in enumerate(zip(shards, params)):
            if isinstance(p, DTensor):
                src = (fulls[i].to(p.device, s.dtype) if rank0
                       else torch.empty(p.shape, dtype=s.dtype, device=p.device))
                s.copy_(distribute_tensor(src, p.device_mesh, p.placements,
                                          src_data_rank=0).to_local())
            else:
                x = (fulls[i].to(dev, s.dtype) if rank0
                     else torch.empty(s.shape, dtype=s.dtype, device=dev))
                tdist.broadcast(x, src=0)
                s.copy_(x)
