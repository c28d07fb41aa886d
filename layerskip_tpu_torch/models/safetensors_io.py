"""A small reader and writer of the safetensors format, so checkpoints load
and save without the ``safetensors`` package.

A file is an 8-byte little-endian header length N, N bytes of JSON header
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}``, plus an
optional ``"__metadata__"`` of strings) and then the raw little-endian
buffers, whose offsets count from the end of the header. The reader maps the
file and copies each tensor out of the map, so the result owns its memory;
BF16 is read as uint16 and viewed as ``torch.bfloat16``, as numpy has no
bfloat16.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import numpy as np
import torch

# safetensors dtype tag -> (numpy dtype of the raw buffer, torch dtype): the
# tags the JAX package's reader decodes (layerskip_tpu/native.py)
_DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}
_TAGS = {tdt: tag for tag, (_, tdt) in _DTYPES.items()}


def _read_header(raw: np.ndarray, path: str):
    if raw.size < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", raw[:8].tobytes())
    if 8 + n > raw.size:
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    return json.loads(raw[8:8 + n].tobytes()), 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor for every tensor of one ``.safetensors`` file."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    header, base = _read_header(raw, path)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype {meta['dtype']}")
        np_dt, t_dt = _DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        shape = tuple(int(s) for s in meta["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * np.dtype(np_dt).itemsize or base + end > raw.size:
            raise ValueError(f"{path}: {name} has offsets {begin}-{end} that do not "
                             f"hold {meta['dtype']} {list(shape)}")
        t = torch.from_numpy(np.array(raw[base + begin:base + end]).view(np_dt).reshape(shape))
        out[name] = t.view(t_dt) if t_dt == torch.bfloat16 else t
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device, any dtype of ``_DTYPES``) to ``path``:
    the header padded with spaces to a multiple of 8 bytes, then the buffers
    back to back in name order (the format allows no gaps between them).
    One tensor at a time is copied to the host."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    names, offset = sorted(tensors), 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _TAGS:
            raise ValueError(f"{name}: dtype {t.dtype} cannot be saved")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous()
            f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
