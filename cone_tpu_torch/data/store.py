"""Feature stores: key -> (L, D) float array (pure numpy).

The packed store (.cfs) is one contiguous mmap-able matrix plus a key
index; the port reads and writes the same format as the JAX package.

Packed store layout (little-endian):
    magic  b"CFST"  | version u32 | dim u32 | dtype u8 (0=f32,1=f16) |
    n_entries u64   | index_offset u64 | payload rows | index
    index entry: key_len u16 | key utf-8 | row_start u64 | n_rows u64
"""

from __future__ import annotations

import io
import struct
from typing import Dict, Iterable, Protocol, Tuple

import numpy as np

_MAGIC = b"CFST"
_HEADER = "<IIBQQ"
_HEADER_SIZE = 4 + struct.calcsize(_HEADER)
_DTYPES = {0: np.float32, 1: np.float16}
_DTYPE_IDS = {np.dtype(np.float32): 0, np.dtype(np.float16): 1}


class FeatureStore(Protocol):
    def get(self, key: str) -> np.ndarray: ...
    def keys(self) -> Iterable[str]: ...
    def __contains__(self, key: str) -> bool: ...


class InMemoryArrayStore:
    """Dict-backed store."""

    def __init__(self, data: Dict[str, np.ndarray]):
        self._data = data

    def get(self, key: str) -> np.ndarray:
        return self._data[key]

    def keys(self):
        return self._data.keys()

    def __contains__(self, key):
        return key in self._data


def write_packed_store(path: str, items: Dict[str, np.ndarray]) -> None:
    """Write a packed .cfs store. All arrays must share dim and dtype."""
    arrays = {k: np.ascontiguousarray(v) for k, v in items.items()}
    if not arrays:
        raise ValueError(f"refusing to write an empty store to {path}")
    first = next(iter(arrays.values()))
    dim, dtype = first.shape[-1], first.dtype
    if dtype not in _DTYPE_IDS:
        raise ValueError(f"unsupported store dtype {dtype}")
    for k, a in arrays.items():
        if a.shape[-1] != dim or a.dtype != dtype:
            raise ValueError(f"{k}: {a.shape} {a.dtype} != (..., {dim}) {dtype}")

    payload = io.BytesIO()
    index = []
    row = 0
    for key, arr in arrays.items():
        n = arr.shape[0] if arr.ndim == 2 else 1
        payload.write(arr.tobytes())
        index.append((key, row, n))
        row += n

    body = payload.getvalue()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack(_HEADER, 1, dim, _DTYPE_IDS[dtype], len(index),
                            _HEADER_SIZE + len(body)))
        f.write(body)
        for key, start, n in index:
            kb = key.encode()
            f.write(struct.pack("<H", len(kb)))
            f.write(kb)
            f.write(struct.pack("<QQ", start, n))


class PackedArrayStore:
    """mmap-backed reader for the packed .cfs format (zero-copy slicing)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            if f.read(4) != _MAGIC:
                raise ValueError(f"not a packed store: {path}")
            version, dim, dt, n_entries, index_offset = struct.unpack(
                _HEADER, f.read(_HEADER_SIZE - 4))
            if version != 1:
                raise ValueError(f"{path}: unsupported store version {version}")
            self.dim = dim
            self.dtype = _DTYPES[dt]
            f.seek(index_offset)
            self._index: Dict[str, Tuple[int, int]] = {}
            for _ in range(n_entries):
                (klen,) = struct.unpack("<H", f.read(2))
                key = f.read(klen).decode()
                start, n = struct.unpack("<QQ", f.read(16))
                self._index[key] = (start, n)
        total_rows = (index_offset - _HEADER_SIZE) // (
            dim * np.dtype(self.dtype).itemsize)
        self._mat = np.memmap(path, dtype=self.dtype, mode="r",
                              offset=_HEADER_SIZE, shape=(total_rows, dim))

    def get(self, key: str) -> np.ndarray:
        start, n = self._index[key]
        return np.asarray(self._mat[start : start + n])

    def keys(self):
        return self._index.keys()

    def __contains__(self, key):
        return key in self._index


class TextFeatureStore:
    """Query text features: per-query token matrix (Lq, D) + holistic CLS
    vector ((1, D) or (D,))."""

    def __init__(self, tokens: FeatureStore, cls: FeatureStore):
        self.tokens = tokens
        self.cls = cls

    def get_tokens(self, qid: str) -> np.ndarray:
        return self.tokens.get(qid)

    def get_cls(self, qid: str) -> np.ndarray:
        arr = self.cls.get(qid)
        return arr[0] if arr.ndim == 2 else arr
