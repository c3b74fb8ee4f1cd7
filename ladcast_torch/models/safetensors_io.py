"""A reader and a writer of the safetensors file format on numpy and torch
(the ``safetensors`` package is not required).

The format: 8 bytes, the little-endian length N of the header; N bytes of
JSON mapping each tensor name to ``{"dtype", "shape", "data_offsets":
[begin, end]}`` (offsets into the byte buffer after the header; an optional
``__metadata__`` entry holds strings); then the tensors' raw little-endian
bytes, C order.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import numpy as np
import torch

# format name -> (torch dtype, numpy dtype that carries its bytes)
_DTYPES = {
    "F64": (torch.float64, np.dtype("<f8")),
    "F32": (torch.float32, np.dtype("<f4")),
    "F16": (torch.float16, np.dtype("<f2")),
    "BF16": (torch.bfloat16, np.dtype("<i2")),
    "I64": (torch.int64, np.dtype("<i8")),
    "I32": (torch.int32, np.dtype("<i4")),
    "I16": (torch.int16, np.dtype("<i2")),
    "I8": (torch.int8, np.dtype("i1")),
    "U8": (torch.uint8, np.dtype("u1")),
    "BOOL": (torch.bool, np.dtype("u1")),
}
_NAMES = {t: name for name, (t, _) in _DTYPES.items()}
_MAX_HEADER = 100 * 2 ** 20


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on the CPU, in its stored
    dtype."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", head)
        if n > min(_MAX_HEADER, size - 8):
            raise ValueError(f"{path}: header length {n} does not fit the file")
        header = json.loads(f.read(n).decode("utf-8"))
        data = np.fromfile(f, dtype=np.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype "
                             f"{info['dtype']!r}")
        tdtype, ndtype = _DTYPES[info["dtype"]]
        shape = tuple(int(d) for d in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        if not (0 <= begin <= end <= data.size
                and end - begin == count * ndtype.itemsize):
            raise ValueError(f"{path}: tensor {name!r} has offsets "
                             f"{(begin, end)} for shape {shape}")
        # a copy: aligned, writable, independent of the file buffer
        arr = np.array(data[begin:end].view(ndtype)).reshape(shape)
        t = torch.from_numpy(arr)
        out[name] = t.view(tdtype) if t.dtype != tdtype else t
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; stored contiguous, in their dtype) as
    one safetensors file, through a temporary name."""
    header, offset, order = {}, 0, sorted(tensors)
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: unsupported dtype {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)  # the tensors start 8-byte aligned
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().cpu().contiguous()
            carrier = _DTYPES[_NAMES[t.dtype]][1]
            raw = t.view(torch.uint8) if t.dtype == torch.bool else t
            if raw.dtype == torch.bfloat16:
                raw = raw.view(torch.int16)
            f.write(raw.numpy().astype(carrier, copy=False).tobytes())
    os.replace(tmp, path)
