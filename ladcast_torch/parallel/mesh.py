"""Device meshes over the ranks of the process group (the port of
``ladcast_tpu/parallel/mesh.py``).

One rank is one card, so a mesh's sizes multiply to the world size where
the JAX package's multiply to the device count. The axes serve as they do
there: ``data`` splits the global batch, ``model`` shards the parameters
(``parallel.sharding_rules``); the last axis varies fastest, so the
``model`` groups are neighbouring ranks. The mesh is
``torch.distributed.device_mesh.init_device_mesh``'s. A single process
without a process group has no mesh: the spec is checked against one rank
and the functions return None, the single-device regime.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ladcast_torch.parallel import dist


def mesh_sizes(spec, n: int) -> List[Tuple[str, int]]:
    """The (axis, size) pairs of an axis-size spec over ``n`` ranks.

    ``spec`` is a string ``"data=-1,model=2"`` (CLI form) or an ordered
    mapping ``{"data": -1, "model": 2}`` (yaml ``parallel.mesh`` form). At
    most one axis may be ``-1`` ("fill with the remaining ranks"); the
    product of the sizes must equal ``n``. The errors are the JAX
    function's, ranks counted as devices."""
    if isinstance(spec, str):
        pairs = []
        for part in spec.split(","):
            name, _, size = part.partition("=")
            pairs.append((name.strip(), int(size) if size else -1))
    else:
        pairs = [(str(k), int(v)) for k, v in spec.items()]
    if not pairs:
        raise ValueError("empty mesh spec")
    bad = [(k, s) for k, s in pairs if s != -1 and s <= 0]
    if bad:
        raise ValueError(f"mesh axis sizes must be -1 or positive, got "
                         f"{bad} in {pairs}")
    fills = [i for i, (_, s) in enumerate(pairs) if s == -1]
    if len(fills) > 1:
        raise ValueError(f"at most one -1 axis in mesh spec, got {pairs}")
    fixed = int(np.prod([s for _, s in pairs if s != -1]))
    if fills:
        if n % fixed != 0:
            raise ValueError(f"mesh spec {pairs} does not divide {n} devices")
        pairs[fills[0]] = (pairs[fills[0]][0], n // fixed)
    if int(np.prod([s for _, s in pairs])) != n:
        raise ValueError(f"mesh spec {pairs} != {n} devices")
    return pairs


def make_mesh_from_spec(spec, device_type: str = "cuda"):
    """The N-D ``DeviceMesh`` of ``spec`` (:func:`mesh_sizes`) over the
    world's ranks, with the spec's axis names; None in a single process
    without a process group."""
    pairs = mesh_sizes(spec, dist.process_count())
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(s for _, s in pairs),
                            mesh_dim_names=tuple(k for k, _ in pairs))


def make_mesh(axis_name: str = "data", device_type: str = "cuda"):
    """1-D mesh over every rank (None without a process group)."""
    return make_mesh_from_spec({axis_name: -1}, device_type)


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple
