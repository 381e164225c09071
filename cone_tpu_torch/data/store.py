"""Feature stores: key -> (L, D) float array.

The packed store (.cfs) is one contiguous mmap-able matrix plus a key
index; the port reads and writes the same format as the JAX package.
`open_array_store` maps a dict to InMemoryArrayStore, a .cfs file to the
native C++ reader (data/native_store.py) and a directory to a reference
LMDB database (LmdbArrayStore, which needs the optional `lmdb` package;
`convert-store --format lmdb` turns one into a .cfs file). The pure-numpy
PackedArrayStore reads the same files and is taken only when the caller
asks for it (reader="python").

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


def read_index(path: str):
    """(dim, dtype, payload rows, {key: (row_start, n_rows)}) of a .cfs
    file, in the file's key order."""
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"not a packed store: {path}")
        version, dim, dt, n_entries, index_offset = struct.unpack(
            _HEADER, f.read(_HEADER_SIZE - 4))
        if version != 1:
            raise ValueError(f"{path}: unsupported store version {version}")
        dtype = _DTYPES[dt]
        f.seek(index_offset)
        index: Dict[str, Tuple[int, int]] = {}
        for _ in range(n_entries):
            (klen,) = struct.unpack("<H", f.read(2))
            key = f.read(klen).decode()
            index[key] = struct.unpack("<QQ", f.read(16))
    rows = (index_offset - _HEADER_SIZE) // (dim * np.dtype(dtype).itemsize)
    return dim, dtype, rows, index


class PackedArrayStore:
    """mmap-backed pure-numpy reader for the packed .cfs format (zero-copy
    slicing)."""

    def __init__(self, path: str):
        self.path = path
        self.dim, self.dtype, total_rows, self._index = read_index(path)
        self._mat = np.memmap(path, dtype=self.dtype, mode="r",
                              offset=_HEADER_SIZE, shape=(total_rows, self.dim))

    def get(self, key: str) -> np.ndarray:
        start, n = self._index[key]
        return np.asarray(self._mat[start : start + n])

    def read_batch(self, keys, max_rows: int):
        """(N, max_rows, D) zero-padded batch + (N,) true lengths; a missing
        key gives a zero slot of length 0 (the native reader's cfs_read_batch)."""
        out = np.zeros((len(keys), max_rows, self.dim), self.dtype)
        lengths = np.zeros(len(keys), np.int64)
        for i, k in enumerate(keys):
            if k in self._index:
                start, n = self._index[k]
                n = min(n, max_rows)
                out[i, :n] = self._mat[start : start + n]
                lengths[i] = n
        return out, lengths

    def keys(self):
        return self._index.keys()

    def __contains__(self, key):
        return key in self._index


def open_array_store(path_or_dict, reader: str = "native") -> FeatureStore:
    """A dict -> InMemoryArrayStore; a .cfs path -> NativePackedStore, or
    PackedArrayStore with reader="python"; any other path -> LmdbArrayStore
    (a reference LMDB directory). The native reader builds at the first
    open and raises with the compiler's output if it cannot: nothing falls
    back to the Python reader. It opens with no prefetch threads, since the
    dataset only calls `get`; a caller that prefetches opens
    NativePackedStore with its own thread count."""
    if reader not in ("native", "python"):
        raise ValueError(f"reader must be 'native' or 'python', not {reader!r}")
    if isinstance(path_or_dict, dict):
        return InMemoryArrayStore(path_or_dict)
    path = str(path_or_dict)
    if path.endswith(".cfs"):
        if reader == "python":
            return PackedArrayStore(path)
        from cone_tpu_torch.data.native_store import NativePackedStore

        return NativePackedStore(path, prefetch_threads=0)
    return LmdbArrayStore(path)


class LmdbArrayStore:
    """Reader for reference-produced LMDB feature databases: npz blobs keyed
    by id, read as float32 from their `array_key` array
    (cone/ego4d_mad_dataloader.py:284-302). Needs the optional `lmdb`
    package, imported here at construction."""

    def __init__(self, path: str, array_key: str = "features"):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError(
                "lmdb not installed; convert the database to a packed .cfs store with "
                "`python -m cone_tpu_torch convert-store --format lmdb` on a host that "
                "has lmdb") from e
        self._env = lmdb.open(path, readonly=True, create=False, readahead=False)
        self._txn = self._env.begin(buffers=True)
        self.array_key = array_key

    def get(self, key: str) -> np.ndarray:
        dump = self._txn.get(key.encode())
        if dump is None:
            raise KeyError(key)
        with io.BytesIO(dump) as reader:
            return np.load(reader, allow_pickle=False)[self.array_key].astype(np.float32)

    def keys(self):
        with self._env.begin() as txn:
            return [bytes(k).decode() for k, _ in txn.cursor()]

    def __contains__(self, key):
        return self._txn.get(key.encode()) is not None


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
