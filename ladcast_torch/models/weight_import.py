"""JAX (flax) parameter trees -> the port's state dicts.

A self-contained copy of the export direction of
``ladcast_tpu/models/weight_import.py``: the flax tree of the DCAE or the
DiT (nested dicts of numpy arrays) becomes a state dict in the reference
diffusers names and torch layouts, which is what the port's modules use,
so it loads with ``load_state_dict(strict=True)``.

Layout conversions:
  flax Dense kernel (in, out)       -> torch Linear (out, in)
  HWIO conv kernel (kh, kw, I/g, O) -> OIHW (O, I/g, kh, kw)
  Dense patch embed (I, O)          -> Conv3d 1x1x1 (O, I, 1, 1, 1)
  Dense GLUMBConv 1x1 (I, O)        -> Conv2d 1x1 (O, I, 1, 1)
  grouped 1x1 einsum (g, gs, gs)    -> grouped Conv2d 1x1 (g*gs, gs, 1, 1)

The DCAE's timestep conditioning follows the same rules: its
``timestep_embedder/linear_1`` keeps its name (not an index), and the
blocks' ``time_emb_porj`` and ``norm_in/linear`` Dense kernels transpose.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_DIT_RENAMES = {
    "x_embedder": "x_embedder.proj",
    "context_embedder": "context_embedder.proj",
    "norm_out_linear": "norm_out.linear",
    "text_embedder_linear_1": "text_embedder.linear_1",
    "text_embedder_linear_2": "text_embedder.linear_2",
    "to_out": "to_out.0",
}
_QK_NORM_LEAVES = ("norm_q_weight", "norm_k_weight",
                   "norm_added_q_weight", "norm_added_k_weight")
_INDEXED_STEMS = ("transformer_blocks", "single_transformer_blocks",
                  "refiner_blocks")


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _indexed(p: str):
    """'down_blocks_3' -> ('down_blocks', '3'), else None."""
    stem, _, idx = p.rpartition("_")
    return (stem, idx) if stem and idx.isdigit() else None


def _dcae_name(path: Tuple[str, ...]) -> str:
    *mods, leaf = path
    parts = []
    for p in mods:
        split = None if p in ("linear_1", "linear_2") else _indexed(p)
        parts.extend(split or (p,))
    if leaf == "proj_out_kernel":  # grouped 1x1 of the Sana projection
        return ".".join(parts + ["proj_out", "weight"])
    if leaf == "kernel":
        leaf = "weight"
    return ".".join(parts + [leaf])


def _dit_name(path: Tuple[str, ...]) -> str:
    if path[-1] in _QK_NORM_LEAVES:  # flat params here, submodules there
        path = path[:-1] + (path[-1][: -len("_weight")], "weight")
    *mods, leaf = path
    parts = []
    for i, p in enumerate(mods):
        split = _indexed(p)
        if split and split[0] in _INDEXED_STEMS:
            parts.extend(split)
        elif p in _DIT_RENAMES:
            parts.append(_DIT_RENAMES[p])
        elif p == "proj_in" and i > 0 and mods[i - 1] in ("ff", "ff_context"):
            parts.append("net.0.proj")
        elif p == "proj_out" and i > 0 and mods[i - 1] in ("ff", "ff_context"):
            parts.append("net.2")
        else:
            parts.append(p)
    name = ".".join(parts).replace("context_refiner.refiner_blocks",
                                   "context_refiner.token_refiner.refiner_blocks")
    return f"{name}.{'weight' if leaf == 'kernel' else leaf}"


def state_dict_from_flax(params: Dict, kind: str) -> Dict[str, torch.Tensor]:
    """``params``: a flax variable tree ({'params': ...}) of numpy arrays;
    ``kind``: 'dcae' or 'dit'. Returns fp32 torch tensors by reference
    name."""
    if kind not in ("dcae", "dit"):
        raise ValueError(f"kind {kind!r}: expected 'dcae' or 'dit'")
    sd = {}
    for path, w in _flatten(params["params"]).items():
        w = np.asarray(w)
        leaf = path[-1]
        if kind == "dcae":
            name = _dcae_name(path)
        else:
            name = _dit_name(path)
        if leaf == "proj_out_kernel":  # (g, gs_in, gs_out) einsum weight
            g, gs_in, gs_out = w.shape
            w = np.transpose(w, (0, 2, 1)).reshape(g * gs_out, gs_in, 1, 1)
        elif leaf == "kernel" and w.ndim == 4:  # HWIO -> OIHW
            w = np.transpose(w, (3, 2, 0, 1))
        elif leaf == "kernel":  # Dense (in, out) -> (out, in)
            w = np.transpose(w, (1, 0))
            if kind == "dit" and path[-2] in ("x_embedder", "context_embedder"):
                w = w[:, :, None, None, None]
            elif kind == "dcae" and path[-2] in ("conv_inverted", "conv_point"):
                w = w[:, :, None, None]
        sd[name] = torch.from_numpy(np.array(w, dtype=np.float32, order="C"))
    return sd
