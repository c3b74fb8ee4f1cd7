"""Diffusers hub-directory checkpoints (the port of
``ladcast_tpu/models/hub.py``).

The published artifacts are diffusers ``save_pretrained`` directories: a
``config.json`` next to ``diffusion_pytorch_model.safetensors``, possibly
sharded with a ``diffusion_pytorch_model.safetensors.index.json`` weight
map. Training checkpoints nest the model under ``ar_model/`` with an EMA
mirror under ``ar_model_ema/``, whose ``config.json`` carries extra EMA
keys (decay, power, optimization_step, ...).

The port's modules use the reference's parameter names and layouts, so a
directory's state dict loads with ``load_state_dict(strict=True)`` and is
written as it is: :func:`load_pretrained` returns (kind, config, state
dict) and :func:`build_model` makes the module from them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, NamedTuple, Optional

import torch

from ladcast_torch import resolve_device
from ladcast_torch.config import DCAEConfig, LaDCastDiTConfig
from ladcast_torch.models.safetensors_io import load_file, save_file

SAFETENSORS_NAME = "diffusion_pytorch_model.safetensors"
INDEX_NAME = "diffusion_pytorch_model.safetensors.index.json"
CONFIG_NAME = "config.json"

# diffusers EMAModel.save_pretrained merges its state dict (minus the
# shadow parameters) into the model config: EMA metadata, not model config.
_EMA_CONFIG_KEYS = frozenset({
    "decay", "min_decay", "optimization_step", "update_after_step",
    "use_ema_warmup", "inv_gamma", "power", "foreach", "model_cls",
})

_CLASS_KINDS = {
    "LaDCastTransformer3DModel": "dit",
    "AutoencoderDC": "dcae",
}
_KIND_CLASSES = {v: k for k, v in _CLASS_KINDS.items()}

# Subfolders probed when `path` itself has no config.json, most preferred
# first (the EMA weights are what the reference evaluates and ships).
_KNOWN_SUBFOLDERS = ("ar_model_ema", "ar_model", "DCAE", "dcae")

# diffusers shards at 10 GB by default
DEFAULT_MAX_SHARD_BYTES = 10 * 1024 ** 3


class HubModel(NamedTuple):
    kind: str          # "dit" | "dcae"
    config: object     # LaDCastDiTConfig | DCAEConfig
    params: Dict[str, torch.Tensor]  # state dict, reference names, on the CPU


def _candidate_subfolders(path: str):
    return [name for name in sorted(os.listdir(path))
            if os.path.isfile(os.path.join(path, name, CONFIG_NAME))]


def is_hub_dir(path: str) -> bool:
    """Whether ``path`` looks like a diffusers model directory
    (config.json at top level or in a subfolder)."""
    if not os.path.isdir(path):
        return False
    if os.path.isfile(os.path.join(path, CONFIG_NAME)):
        return True
    return bool(_candidate_subfolders(path))


def resolve_model_dir(path: str, subfolder: Optional[str] = None) -> str:
    """The directory that holds config.json and the weights: ``path``
    itself, a training checkpoint's ``ar_model_ema/`` (preferred) or
    ``ar_model/``, or the only model subfolder."""
    if subfolder:
        sub = os.path.join(path, subfolder)
        if not os.path.isfile(os.path.join(sub, CONFIG_NAME)):
            raise FileNotFoundError(
                f"no {CONFIG_NAME} in requested subfolder {sub}")
        return sub
    if os.path.isfile(os.path.join(path, CONFIG_NAME)):
        return path
    cands = _candidate_subfolders(path)
    for name in _KNOWN_SUBFOLDERS:
        if name in cands:
            return os.path.join(path, name)
    if len(cands) == 1:
        return os.path.join(path, cands[0])
    raise FileNotFoundError(
        f"no {CONFIG_NAME} under {path}; model subfolders found: "
        f"{cands or 'none'} (pass subfolder= to disambiguate)")


def _tupled(v):
    if isinstance(v, list):
        return tuple(_tupled(x) for x in v)
    return v


def parse_config_dict(raw: Dict) -> "tuple[str, object]":
    """A diffusers config.json dict -> (kind, config dataclass). Unknown
    keys that are not metadata raise: dropping a model option would load
    the weights into the wrong architecture."""
    cls_name = raw.get("_class_name")
    if cls_name not in _CLASS_KINDS:
        raise ValueError(f"unrecognized _class_name {cls_name!r} (known: "
                         f"{sorted(_CLASS_KINDS)})")
    kind = _CLASS_KINDS[cls_name]
    cfg_cls = LaDCastDiTConfig if kind == "dit" else DCAEConfig
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    kw, unknown = {}, []
    for k, v in raw.items():
        if k.startswith("_") or k in _EMA_CONFIG_KEYS:
            continue
        if k not in fields:
            unknown.append(k)
            continue
        kw[k] = _tupled(v)
    if unknown:
        raise ValueError(f"config.json keys not supported by "
                         f"{cfg_cls.__name__}: {sorted(unknown)}")
    if kind == "dcae":
        n = len(kw.get("encoder_block_out_channels",
                       DCAEConfig.encoder_block_out_channels))
        # diffusers allows a bare string where a per-stage tuple is meant
        for key in ("encoder_block_types", "decoder_block_types",
                    "decoder_norm_types", "decoder_act_fns"):
            if isinstance(kw.get(key), str):
                kw[key] = (kw[key],) * n
        if kw.get("out_channels") is None:
            kw["out_channels"] = kw.get("in_channels", DCAEConfig.in_channels)
    else:
        for key in ("rope_spatial_grid_start_pos", "rope_spatial_grid_end_pos"):
            v = kw.get(key)
            if isinstance(v, (int, float)):
                kw[key] = (float(v), float(v))
        if kw.get("rope_spatial_grid_end_pos") is None:
            raise ValueError(
                "rope_spatial_grid_end_pos=None (integer-index RoPE grid) "
                "is not supported; shipped configs always set it")
        if kw.get("out_channels") is None:
            kw["out_channels"] = kw.get("in_channels",
                                        LaDCastDiTConfig.in_channels)
        # the JAX package's names of the attention implementations
        impl = kw.get("attention_impl", "auto")
        kw["attention_impl"] = {"xla": "plain", "pallas": "auto"}.get(impl, impl)
    return kind, cfg_cls(**kw)


def load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """The state dict of a model directory: one safetensors file or the
    index-sharded layout."""
    index_path = os.path.join(model_dir, INDEX_NAME)
    if os.path.isfile(index_path):
        with open(index_path) as f:
            weight_map = json.load(f)["weight_map"]
        out: Dict[str, torch.Tensor] = {}
        for shard in sorted(set(weight_map.values())):
            out.update(load_file(os.path.join(model_dir, shard)))
        missing = set(weight_map) - set(out)
        if missing:
            raise ValueError(f"index lists tensors missing from shards: "
                             f"{sorted(missing)[:5]} ({len(missing)} total)")
        return out
    single = os.path.join(model_dir, SAFETENSORS_NAME)
    if os.path.isfile(single):
        return load_file(single)
    sts = [f for f in os.listdir(model_dir) if f.endswith(".safetensors")]
    if len(sts) == 1:
        return load_file(os.path.join(model_dir, sts[0]))
    raise FileNotFoundError(
        f"no {SAFETENSORS_NAME} / {INDEX_NAME} in {model_dir} "
        f"(found: {sts or 'no safetensors files'})")


def config_to_dict(kind: str, cfg) -> Dict:
    """Config dataclass -> diffusers-style config.json dict (what
    :func:`parse_config_dict` reads back; tuples become JSON lists)."""
    def jsonable(v):
        if isinstance(v, tuple):
            return [jsonable(x) for x in v]
        return v

    raw = {"_class_name": _KIND_CLASSES[kind]}
    for f in dataclasses.fields(type(cfg)):
        raw[f.name] = jsonable(getattr(cfg, f.name))
    return raw


def save_pretrained(path: str, kind: str, cfg,
                    params: Dict[str, torch.Tensor],
                    ema_metadata: Optional[Dict] = None,
                    max_shard_bytes: int = DEFAULT_MAX_SHARD_BYTES) -> None:
    """Write a diffusers ``save_pretrained``-layout directory:
    ``config.json`` and the state dict ``params`` (a module's
    ``state_dict()``) in one ``diffusion_pytorch_model.safetensors`` or, past
    ``max_shard_bytes``, in index-sharded files. ``ema_metadata``: EMA keys
    merged into config.json, as diffusers ``EMAModel.save_pretrained``
    writes ``ar_model_ema/``."""
    os.makedirs(path, exist_ok=True)
    raw = config_to_dict(kind, cfg)
    if ema_metadata:
        raw.update({k: v for k, v in ema_metadata.items()
                    if k in _EMA_CONFIG_KEYS})
    with open(os.path.join(path, CONFIG_NAME), "w") as f:
        json.dump(raw, f, indent=2, sort_keys=True)

    def nbytes(t):
        return t.numel() * t.element_size()

    total = sum(nbytes(v) for v in params.values())
    if total <= max_shard_bytes:
        save_file(params, os.path.join(path, SAFETENSORS_NAME))
        return
    shards, cur, cur_bytes = [], {}, 0
    for k in sorted(params):
        v = params[k]
        if cur and cur_bytes + nbytes(v) > max_shard_bytes:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[k] = v
        cur_bytes += nbytes(v)
    shards.append(cur)
    stem = SAFETENSORS_NAME[: -len(".safetensors")]
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = f"{stem}-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(shard, os.path.join(path, fname))
        weight_map.update({k: fname for k in shard})
    with open(os.path.join(path, INDEX_NAME), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2, sort_keys=True)


def load_pretrained(path: str, subfolder: Optional[str] = None,
                    expect_kind: Optional[str] = None) -> HubModel:
    """A diffusers model directory -> (kind, config, state dict)."""
    model_dir = resolve_model_dir(path, subfolder)
    with open(os.path.join(model_dir, CONFIG_NAME)) as f:
        raw = json.load(f)
    kind, cfg = parse_config_dict(raw)
    if expect_kind is not None and kind != expect_kind:
        raise ValueError(
            f"{model_dir} holds a {kind} model (_class_name="
            f"{raw.get('_class_name')!r}), expected {expect_kind}")
    return HubModel(kind, cfg, load_state_dict(model_dir))


def build_model(kind: str, cfg, params: Dict[str, torch.Tensor],
                device="cuda", dtype: torch.dtype = torch.float32):
    """The DiT or the DCAE of ``cfg`` holding ``params`` (every name
    must match), on ``device`` in ``dtype``, in eval mode."""
    from ladcast_torch.models.dcae import AutoencoderDC
    from ladcast_torch.models.ladcast_dit import LaDCastTransformer3D

    if kind not in _KIND_CLASSES:
        raise ValueError(f"kind {kind!r}: expected 'dit' or 'dcae'")
    device = resolve_device(device)
    with torch.device("meta"):
        model = LaDCastTransformer3D(cfg) if kind == "dit" else AutoencoderDC(cfg)
    model.load_state_dict(
        {k: v.to(device=device, dtype=dtype) if v.is_floating_point()
         else v.to(device) for k, v in params.items()},
        strict=True, assign=True)
    return model.eval()
