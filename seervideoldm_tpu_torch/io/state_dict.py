"""Weight files to ``{name: tensor}`` (port of
``seervideoldm_tpu/io/convert.py::load_torch_state_dict``), with the port's
own ``.safetensors`` reader and writer: the package ``safetensors`` is not
imported.

The ``.safetensors`` format: an 8-byte little-endian header length, a
JSON header ``{name: {"dtype", "shape", "data_offsets": [begin, end]},
"__metadata__"?: {str: str}}``, then the raw little-endian bytes, each
tensor's ``data_offsets`` counted from the end of the header.  numpy has
no bfloat16, so ``BF16`` is read as ``uint16`` and viewed as
``torch.bfloat16``.

``.bin`` / ``.pt`` files go through ``torch.load(map_location="cpu",
weights_only=True)``, taking ``["state_dict"]`` when the file nests one.
Tensors keep the dtype they were stored in: a loader casts each to its
module's dtype.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Mapping, Optional

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the stored bytes, torch dtype): the
# types SD-1.5, CLIP and Seer weight files use
_DTYPES = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "I64": (np.dtype("<i8"), torch.int64),
}
_NAMES = {t: name for name, (_, t) in _DTYPES.items()}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU, in its stored
    dtype.  Raises on a malformed header or offsets outside the file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
    data = (np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
            if os.path.getsize(path) > 8 + n else np.zeros(0, np.uint8))
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']!r}, not one of {sorted(_DTYPES)}")
        np_dtype, torch_dtype = _DTYPES[info["dtype"]]
        shape = tuple(int(s) for s in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        if not 0 <= begin <= end <= len(data) or (
                end - begin != int(np.prod(shape)) * np_dtype.itemsize):
            raise ValueError(f"{path}: tensor {name!r} {info['dtype']} "
                             f"{list(shape)} has offsets [{begin}, {end}] "
                             f"(data section {len(data)} bytes)")
        arr = np.frombuffer(data[begin:end], dtype=np_dtype).reshape(shape)
        t = torch.from_numpy(arr.copy())
        out[name] = t.view(torch.bfloat16) if torch_dtype == torch.bfloat16 else t
    return out


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                      metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` (any device) as a ``.safetensors`` file, in name
    order, the header padded with spaces to a multiple of 8 bytes as the
    package does.  Returns the bytes written."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no "
                             "safetensors name")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)
    return 8 + len(text) + offset


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` or torch pickle (``.bin`` / ``.pt``) weight file
    as ``{name: CPU tensor}``."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)
