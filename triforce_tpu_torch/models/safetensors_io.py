"""Reader and writer of the safetensors file format, with no dependency on
the ``safetensors`` package (the card's machine has none).

A file is an 8-byte little-endian header length N, then N bytes of JSON
``{name: {"dtype": "BF16", "shape": [...], "data_offsets": [begin, end]},
"__metadata__": {str: str}}``, then the payload: every tensor's raw
little-endian bytes, back to back, ``data_offsets`` counted from the
payload's first byte.

``SafeFile`` reads one tensor at a time (seek, ``readinto`` a CPU buffer,
``torch.frombuffer``), so a loader holds at most one tensor on the host.
``save_file`` is the inverse. Both refuse what does not fit the format: a
header or an offset past the end of the file, a byte count that does not
match the shape, an unknown dtype.
"""

from __future__ import annotations

import json
import os
import struct
import sys
from typing import Dict, Optional

import torch

DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "F16": torch.float16, "BF16": torch.bfloat16, "F32": torch.float32,
    "F64": torch.float64,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 2**20          # the format's own limit on the JSON


def _check_host() -> None:
    if sys.byteorder != "little":
        raise RuntimeError("safetensors payloads are little-endian; this "
                           "host is not")


class SafeFile:
    """An open safetensors file: ``keys()``, ``dtype_shape(name)``,
    ``get(name)`` (one tensor on the CPU) and ``metadata``. Use it as a
    context manager, or call ``close``."""

    def __init__(self, path: str):
        _check_host()
        self.path = path
        self._f = open(path, "rb")
        try:
            self._parse()
        except BaseException:
            self._f.close()
            raise

    def _parse(self) -> None:
        size = os.fstat(self._f.fileno()).st_size
        head = self._f.read(8)
        if len(head) != 8:
            raise ValueError(f"{self.path}: shorter than a safetensors "
                             f"header")
        (n,) = struct.unpack("<Q", head)
        if n > min(_MAX_HEADER, size - 8):
            raise ValueError(f"{self.path}: header of {n} bytes overruns "
                             f"the file ({size} bytes)")
        header = json.loads(self._f.read(n).decode("utf-8"))
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) \
            or {}
        self._base = 8 + n
        payload = size - self._base
        self._entries = {}
        for name, e in header.items():
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                                 f"{e['dtype']!r}, not one of "
                                 f"{sorted(DTYPES)}")
            dtype = DTYPES[e["dtype"]]
            shape = tuple(int(s) for s in e["shape"])
            begin, end = (int(o) for o in e["data_offsets"])
            numel = 1
            for s in shape:
                numel *= s
            nbytes = numel * torch.empty((), dtype=dtype).element_size()
            if not 0 <= begin <= end <= payload:
                raise ValueError(f"{self.path}: tensor {name!r} at bytes "
                                 f"[{begin}, {end}) overruns the payload of "
                                 f"{payload} bytes")
            if end - begin != nbytes:
                raise ValueError(f"{self.path}: tensor {name!r} holds "
                                 f"{end - begin} bytes, its shape {shape} "
                                 f"needs {nbytes}")
            self._entries[name] = (dtype, shape, begin, end)

    def keys(self):
        return list(self._entries)

    def dtype_shape(self, name: str):
        dtype, shape, _, _ = self._entries[name]
        return dtype, shape

    def get(self, name: str) -> torch.Tensor:
        """One tensor, read from the file into a new CPU tensor."""
        dtype, shape, begin, end = self._entries[name]
        buf = bytearray(end - begin)
        self._f.seek(self._base + begin)
        if self._f.readinto(buf) != len(buf):
            raise ValueError(f"{self.path}: file ended inside {name!r}")
        if not buf:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "SafeFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the CPU one at a time) in
    the order given, back to back, with a space-padded header whose length
    is a multiple of 8."""
    _check_host()
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no "
                             f"safetensors name here")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            flat = t.detach().reshape(-1).contiguous().cpu()
            if flat.numel():
                f.write(flat.view(torch.uint8).numpy().data)
