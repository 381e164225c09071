"""ctypes binding of the port's native .cfs reader (csrc/feature_store.cpp).

Same FeatureStore interface as PackedArrayStore (get, keys, __contains__,
read_batch) plus:
  * read_batch(keys, max_rows) -> padded (N, max_rows, D) + lengths, filled
    by a parallel memcpy in C++;
  * prefetch(keys) -> background page-warming of the entries, so later
    reads do not stall on disk.

The library builds with g++ at the first open (kernels/build.py), never
at import; a failed build raises with the compiler's output. There is no
fallback: the pure-numpy reader is data/store.PackedArrayStore, which a
caller takes by asking for it (open_array_store(..., reader="python")).
"""

from __future__ import annotations

import ctypes

import numpy as np

from cone_tpu_torch.data.store import read_index
from cone_tpu_torch.kernels import build

_VP, _CP, _I64 = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64
_SIGNATURES = {   # name: (restype, argtypes), as in csrc/feature_store.cpp
    "cfs_open": (_VP, [_CP, ctypes.c_int]),
    "cfs_close": (None, [_VP]),
    "cfs_dim": (ctypes.c_uint32, [_VP]),
    "cfs_dtype": (ctypes.c_uint8, [_VP]),
    "cfs_num_entries": (ctypes.c_uint64, [_VP]),
    "cfs_rows": (_I64, [_VP, _CP]),
    "cfs_read": (_I64, [_VP, _CP, _VP, _I64]),
    "cfs_read_batch": (None, [_VP, _CP, _I64, _I64, _VP, ctypes.POINTER(_I64)]),
    "cfs_prefetch": (None, [_VP, _CP, _I64]),
}


def load_reader() -> ctypes.CDLL:
    """The reader's library, built if needed, with its C signatures set."""
    lib = build.load_library("feature_store")
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _key_blob(keys) -> bytes:
    """n NUL-terminated utf-8 keys, concatenated (cfs_read_batch's layout)."""
    enc = [k.encode() for k in keys]
    if any(b"\0" in k for k in enc):
        raise ValueError("a store key holds a NUL byte")
    return b"".join(k + b"\0" for k in enc)


class NativePackedStore:
    """FeatureStore over the C++ reader. keys() come from the Python-side
    index parse (the C side keeps its own index for lookups)."""

    def __init__(self, path: str, prefetch_threads: int = 2):
        self._lib = load_reader()
        self._h = self._lib.cfs_open(path.encode(), prefetch_threads)
        if not self._h:
            raise OSError(f"the native reader refused {path} (unreadable, truncated or "
                          "an index outside the file)")
        self.path = path
        self.dim, self.dtype, _, index = read_index(path)
        self._keys = list(index)
        if (self._lib.cfs_dim(self._h), self._lib.cfs_num_entries(self._h)) != (
                self.dim, len(self._keys)):
            self.close()
            raise OSError(f"{path}: the native index disagrees with the file's header")

    def close(self) -> None:
        """Stop the prefetch threads and unmap the file."""
        if getattr(self, "_h", None):
            self._lib.cfs_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def keys(self):
        return self._keys

    def __contains__(self, key: str) -> bool:
        return self._lib.cfs_rows(self._h, key.encode()) >= 0

    def get(self, key: str) -> np.ndarray:
        rows = self._lib.cfs_rows(self._h, key.encode())
        if rows < 0:
            raise KeyError(key)
        out = np.empty((rows, self.dim), self.dtype)
        got = self._lib.cfs_read(self._h, key.encode(), out.ctypes.data, rows)
        if got != rows:
            raise OSError(f"{self.path}: read {got} rows of {key!r}, want {rows}")
        return out

    def read_batch(self, keys, max_rows: int):
        """(N, max_rows, D) zero-padded batch + (N,) true lengths; a missing
        key gives a zero slot of length 0."""
        if max_rows < 0:
            raise ValueError(f"max_rows {max_rows} < 0")
        keys = list(keys)
        blob = _key_blob(keys)
        out = np.empty((len(keys), max_rows, self.dim), self.dtype)
        lengths = (_I64 * len(keys))()
        self._lib.cfs_read_batch(self._h, blob, len(keys), max_rows, out.ctypes.data, lengths)
        return out, np.asarray(lengths, np.int64)

    def prefetch(self, keys) -> None:
        """Queue the entries for background page-warming (unknown keys are
        skipped)."""
        keys = list(keys)
        self._lib.cfs_prefetch(self._h, _key_blob(keys), len(keys))
