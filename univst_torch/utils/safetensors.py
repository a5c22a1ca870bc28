"""The safetensors format, read and written on ``torch``, ``numpy``, ``json``
and ``struct`` alone, so that loading a checkpoint does not depend on the
``safetensors`` package.

A file is an 8-byte little-endian header length ``N``, ``N`` bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` and an
optional ``"__metadata__"`` of strings), then the data: each tensor's
little-endian, row-major bytes at ``[8 + N + begin, 8 + N + end)``, the
ranges back to back from 0 to the end of the file.

:func:`load_file` maps the file and returns tensors that view the map, so a
file is not copied into host memory before a module copies its tensors in.
:func:`save_file` writes what ``safetensors.numpy.save_file`` writes for the
same dict without metadata, byte for byte: entries (and their data) ordered
by dtype, in the reverse of the Rust crate's ``Dtype`` order (I64, F64, F32,
I32, BF16, F16, I16, I8, U8, BOOL), then by name; the JSON without spaces,
padded with spaces to a multiple of 8 bytes.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Union

import numpy as np
import torch

# name -> (numpy dtype of the stored bytes, torch dtype), in the crate's
# ``Dtype`` order (its derived ``Ord``); BF16 is read as int16 bits
_DTYPES = {
    "BOOL": (np.bool_, torch.bool),
    "U8": (np.uint8, torch.uint8),
    "I8": (np.int8, torch.int8),
    "I16": (np.int16, torch.int16),
    "F16": (np.float16, torch.float16),
    "BF16": (np.int16, torch.bfloat16),
    "I32": (np.int32, torch.int32),
    "F32": (np.float32, torch.float32),
    "F64": (np.float64, torch.float64),
    "I64": (np.int64, torch.int64),
}
_ORDER = {name: i for i, name in enumerate(_DTYPES)}
_BY_TORCH = {t: name for name, (_, t) in _DTYPES.items()}
_BY_NUMPY = {np.dtype(n): name for name, (n, _) in _DTYPES.items() if name != "BF16"}


def _no_duplicates(path: str):
    def hook(pairs):
        out = {}
        for k, v in pairs:
            if k in out:
                raise ValueError(f"{path}: the header names {k!r} twice")
            out[k] = v
        return out
    return hook


def _read_header(path: str):
    """``(entries, data_start)``: the header's tensor entries in file
    order (name -> (dtype, shape, begin, end)) and the data's offset in the
    file. Refuses a header that is not JSON, an unknown dtype, a range that
    does not hold its shape, and ranges that overlap, leave a gap, or run
    past (or stop short of) the end of the file; each error names the file."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, shorter than the 8-byte header length")
        (n,) = struct.unpack("<Q", head)
        if n > size - 8:
            raise ValueError(f"{path}: header length {n} runs past the end of the file "
                             f"({size} bytes)")
        raw = f.read(n)
    try:
        header = json.loads(raw.decode("utf-8"), object_pairs_hook=_no_duplicates(path))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: the header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    header.pop("__metadata__", None)
    entries = {}
    for name, info in header.items():
        try:
            dtype, shape, (begin, end) = info["dtype"], info["shape"], info["data_offsets"]
        except (TypeError, KeyError, ValueError):
            raise ValueError(f"{path}: entry {name!r} is not a tensor entry: {info!r}") from None
        if dtype not in _DTYPES:
            raise ValueError(f"{path}: entry {name!r} has an unknown dtype {dtype!r}")
        if (not isinstance(shape, list)
                or not all(isinstance(d, int) and d >= 0 for d in shape)
                or not all(isinstance(o, int) and o >= 0 for o in (begin, end))):
            raise ValueError(f"{path}: entry {name!r} has a malformed shape or offsets: {info!r}")
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(_DTYPES[dtype][0]).itemsize
        if end - begin != nbytes:
            raise ValueError(f"{path}: entry {name!r} spans [{begin}, {end}), not the "
                             f"{nbytes} bytes of {dtype} {shape}")
        entries[name] = (dtype, tuple(shape), begin, end)
    data_start = 8 + n
    at = 0
    for name, (_, _, begin, end) in sorted(entries.items(), key=lambda kv: kv[1][2:]):
        if begin != at:
            raise ValueError(f"{path}: entry {name!r} begins at {begin}, not at {at}: the "
                             "ranges overlap or leave a gap")
        at = end
    if data_start + at != size:
        raise ValueError(f"{path}: the ranges end at offset {data_start + at}, the file at "
                         f"{size}")
    return entries, data_start


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on the CPU, in header order. The
    tensors view a copy-on-write map of the file (one whose offset is not a
    multiple of its element size is copied out)."""
    path = os.fspath(path)
    entries, data_start = _read_header(path)
    if os.path.getsize(path) == data_start:
        data = np.zeros(0, np.uint8)
    else:
        data = np.memmap(path, dtype=np.uint8, mode="c", offset=data_start)
    out = {}
    for name, (dtype, shape, begin, end) in entries.items():
        np_dtype, torch_dtype = _DTYPES[dtype]
        raw = data[begin:end]
        if (data_start + begin) % np.dtype(np_dtype).itemsize:
            raw = np.array(raw)
        t = torch.from_numpy(raw.view(np_dtype).reshape(shape))
        out[name] = t.view(torch.bfloat16) if torch_dtype == torch.bfloat16 else t
    return out


def _dtype_name(x) -> str:
    name = (_BY_TORCH.get(x.dtype) if isinstance(x, torch.Tensor)
            else _BY_NUMPY.get(np.dtype(x.dtype)))
    if name is None:
        raise TypeError(f"safetensors: no dtype for {x.dtype}")
    return name


def _host_bytes(x) -> np.ndarray:
    """``x``'s data as a flat uint8 array on the host, row-major."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu").contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def save_file(tensors: Mapping[str, Union[torch.Tensor, np.ndarray]], path: str) -> int:
    """Write ``tensors`` (torch tensors on any device, or numpy arrays) as a
    safetensors file without metadata, one tensor at a time (a tensor on a
    card is copied to the host when its turn comes). Returns the bytes
    written."""
    order = sorted(tensors, key=lambda k: (-_ORDER[_dtype_name(tensors[k])], k))
    header, at = {}, 0
    for name in order:
        x = tensors[name]
        nbytes = x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes
        header[name] = {"dtype": _dtype_name(x), "shape": list(x.shape),
                        "data_offsets": [at, at + nbytes]}
        at += nbytes
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            f.write(_host_bytes(tensors[name]))
    return 8 + len(raw) + at
