"""Read the JAX package's checkpoints without JAX, flax or msgpack.

A JAX workdir is `config.json` (which ConeConfig.load reads) plus
flax-msgpack files `model_<tag>.msgpack`, each

    {"params": tree, "opt_state": tree or None, "epoch": int32 scalar,
     "extra": {name: float64 scalar}}

(cone_tpu/train/checkpoint.py), or a raw {"params": tree} file
(tools/convert_ckpt.py --out). flax writes them with
msgpack.packb(tree, default=_msgpack_ext_pack, strict_types=True)
(flax/serialization.py:249-311): dicts with str keys, lists, str, bin,
ints, floats, nil, bool, and two extension types, 1 an ndarray and 3 a
numpy scalar, each the msgpack of (shape, dtype name, C-order bytes).
Leaves above 2**30 bytes are split into `__msgpack_chunked_array__` dicts
(:344-390). `msgpack_restore` decodes exactly that subset, in pure Python
and numpy, to what flax's own msgpack_restore returns; anything else (a
complex scalar, another extension type, a non-str map key, trailing bytes)
is refused by name. A bfloat16 leaf, which numpy cannot hold, is widened
exactly to float32.

`state_dict_from_jax` maps a decoded file's params to the state dict of a
model of either family (convert.params_from_jax, convert.tan_params_from_jax).
Only the weights cross: the optax state has no counterpart in the port's
torch optimizers and is not read.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from cone_tpu_torch.convert import params_from_jax, tan_params_from_jax
from cone_tpu_torch.models.tan import ConeTanModel

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

# first byte -> (struct format of the value, or of the length that follows)
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class MsgpackError(ValueError):
    """The bytes are not a flax checkpoint this module decodes."""


class _Decoder:
    def __init__(self, data: bytes, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw   # str as bytes (flax's inner ndarray decode), else utf-8 str

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise MsgpackError(f"truncated: {n} bytes wanted at offset {self.pos}")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _STR:
            return self.str_(self.unpack(_STR[b]))
        if b in _BIN:
            return bytes(self.take(self.unpack(_BIN[b])))
        if b in _ARRAY:
            return [self.obj() for _ in range(self.unpack(_ARRAY[b]))]
        if b in _MAP:
            return self.map_(self.unpack(_MAP[b]))
        if b in _EXT:
            n = self.unpack(_EXT[b])
            return self.ext(self.unpack(">b"), bytes(self.take(n)))
        if b in _FIXEXT:
            code = self.unpack(">b")
            return self.ext(code, bytes(self.take(_FIXEXT[b])))
        raise MsgpackError(f"msgpack type byte 0x{b:02x} (reserved) at offset {self.pos - 1}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, (str, bytes)):
                raise MsgpackError(f"a map key of type {type(k).__name__} (flax writes str keys)")
            out[k] = self.obj()
        return out

    def ext(self, code: int, data: bytes):
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == EXT_COMPLEX:
            raise MsgpackError("extension type 2 (a complex scalar): not in a model checkpoint")
        raise MsgpackError(f"extension type {code}: not one that flax writes")


def _decode(data: bytes, raw: bool):
    d = _Decoder(data, raw)
    out = d.obj()
    if d.pos != len(d.buf):
        raise MsgpackError(f"{len(d.buf) - d.pos} bytes after the object")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    """flax's _ndarray_from_bytes: (shape, dtype name, C-order bytes)."""
    shape, name, buf = _decode(data, raw=True)
    if name == b"bfloat16":   # the high half of a float32: widen exactly
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(bytearray(buf), dtype=np.dtype(name.decode())).reshape(shape)


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = d["chunks"]
    return np.concatenate([chunks[str(i)] for i in range(len(chunks))]).reshape(shape)


def _unchunk_leaves(d):
    """flax's _unchunk_array_leaves_in_place: chunked dicts -> arrays (maps
    only; flax does not look inside lists)."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if CHUNKED in v else _unchunk_leaves(v)
    return d


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore, for the subset flax writes."""
    return _unchunk_leaves(_decode(bytes(data), raw=False))


def read_msgpack(path: str):
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def state_dict_from_jax(raw: dict, model: torch.nn.Module) -> dict:
    """A decoded checkpoint (a CheckpointManager file or a raw {"params":
    ...} file) -> the state dict of `model`'s family and config, for a
    strict load."""
    if not isinstance(raw, dict) or not isinstance(raw.get("params"), dict):
        raise MsgpackError("no 'params' tree: not a flax checkpoint of a model")
    if isinstance(model, ConeTanModel):
        return tan_params_from_jax(raw["params"], model.cfg)
    return params_from_jax(raw["params"], model.cfg)
