"""Flax's msgpack parameter files (``avsum_tpu/utils/serialization.py``)
read and written without JAX, flax or the ``msgpack`` package.

The JAX package persists encoder weights with
``flax.serialization.msgpack_serialize`` and loads them by path from the
config (``visual.weights``, ``audio.vggish_weights``). This module holds a
decoder and an encoder of the msgpack subset that format uses:

- maps, arrays, str and bin, ints, floats, nil and bool;
- ext type 1, an ndarray: a nested msgpack ``(shape, dtype name, C-order
  bytes)``; ext type 3, a numpy scalar, packed as a 0-d ndarray; ext type
  2, a Python complex as ``(real, imag)``;
- Flax's chunked leaves ``{"__msgpack_chunked_array__": True, "chunks":
  {"0": ...}, "shape": {"0": ...}}``, which it writes for a leaf of more
  than ``MAX_CHUNK_SIZE`` bytes (msgpack holds at most 2**31 - 1 bytes in
  one object).

``load_params`` gives the nested dict ``flax.serialization.msgpack_restore``
gives, with one difference: numpy has no bfloat16, so a ``bfloat16`` leaf
comes back as float32, which is exact (its 16 bits are the high half of
the float32's). ``save_params`` writes the bytes Flax writes for the same
tree: keys sorted at every level (Flax copies the tree through
``jax.tree_util`` first, which sorts them) and each value in msgpack's
shortest encoding.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
# Flax's flax.serialization.MAX_CHUNK_SIZE: a leaf over it is chunked
MAX_CHUNK_SIZE = 2 ** 30


class _Reader:
    """msgpack decoding over one buffer. ``raw`` keeps str values as bytes
    (Flax decodes an ndarray's inner record so)."""

    def __init__(self, data, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int):
        raw = bytes(self._take(n))
        return raw if self.raw else raw.decode("utf-8")

    def _ext(self, n: int):
        code = self._unpack(">b")
        return _ext_value(code, self._take(n))

    def value(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        number = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                  0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in number:
            return self._unpack(number[b])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",  # bin
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I",  # ext
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",  # str
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if b in sized:
            n = self._unpack(sized[b])
            if b <= 0xC6:
                return bytes(self._take(n))
            if b <= 0xC9:
                return self._ext(n)
            if b <= 0xDB:
                return self._str(n)
            if b <= 0xDD:
                return [self.value() for _ in range(n)]
            return self._map(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self._ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack byte 0x{b:02x} is not a value")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _unpackb(data, raw: bool = False) -> Any:
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         "msgpack object")
    return out


def _ndarray(data) -> np.ndarray:
    """Flax's ndarray record ``(shape, dtype name, bytes)`` -> the array;
    bfloat16 as float32."""
    shape, name, buf = _unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.dtype("<u2")).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"an ndarray leaf of dtype {name!r}, which numpy "
                         "cannot hold") from None
    return np.frombuffer(buf, dtype).reshape(shape)


def _ext_value(code: int, data) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == EXT_COMPLEX:
        real, imag = _unpackb(data)
        return complex(real, imag)
    raise ValueError(f"msgpack ext type {code} is not one Flax writes")


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """Flax's ``msgpack_restore``: bytes -> the nested dict of arrays."""
    return _unchunk(_unpackb(data))


def load_params(path: str) -> Any:
    """Load a parameter tree written by the JAX package's ``save_params``
    (or by :func:`save_params`)."""
    with open(path, "rb") as fh:
        return msgpack_restore(fh.read())


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def _sized(n: int, small: Tuple[int, int], codes: Tuple[int, int, int]
           ) -> bytes:
    """The header of a str, bin, array or map of ``n`` items: its fix form
    (``small`` = (first code, limit)) when it fits, else 8-, 16- or 32-bit
    lengths (a 0 code skips that width)."""
    first, limit = small
    if first and n < limit:
        return bytes([first | n])
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code and n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} items are more than msgpack holds in one object")


def _int(n: int) -> bytes:
    if 0 <= n < 0x80 or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) \
        if n >= 0 else ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
    for code, fmt in forms:
        try:
            return bytes([code]) + struct.pack(fmt, n)
        except struct.error:
            continue
    raise ValueError(f"{n} does not fit in 64 bits")


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    if n in (1, 2, 4, 8, 16):
        head = bytes([0xD4 + n.bit_length() - 1])
    else:
        head = _sized(n, (0, 0), (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + data


def _packb(x: Any, out: list) -> None:
    """Append msgpack's encoding of ``x`` to ``out`` (Flax's packb with
    ``strict_types``: a numpy scalar, even a float64, is an ext)."""
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        raw = x.encode("utf-8")
        out.append(_sized(len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + raw)
    elif type(x) is bytes:
        out.append(_sized(len(x), (0, 0), (0xC4, 0xC5, 0xC6)) + x)
    elif type(x) in (list, tuple):
        out.append(_sized(len(x), (0x90, 16), (0, 0xDC, 0xDD)))
        for item in x:
            _packb(item, out)
    elif type(x) is dict:
        out.append(_sized(len(x), (0x80, 16), (0, 0xDE, 0xDF)))
        for key, value in x.items():
            _packb(key, out)
            _packb(value, out)
    elif isinstance(x, np.ndarray):
        out.append(_ext(EXT_NDARRAY, _ndarray_bytes(x)))
    elif isinstance(x, np.generic):
        out.append(_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(x))))
    elif type(x) is complex:
        out.append(_ext(EXT_COMPLEX, _pack((x.real, x.imag))))
    else:
        raise TypeError(f"cannot serialize a {type(x).__name__}")


def _pack(x: Any) -> bytes:
    out: list = []
    _packb(x, out)
    return b"".join(out)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes cannot be serialized")
    return _pack((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _chunk(arr: np.ndarray) -> Dict[str, Any]:
    """Flax's chunked leaf, its keys in Flax's order (it chunks after
    sorting)."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True,
            "shape": {str(i): n for i, n in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _prepare(tree: Any) -> Any:
    """Keys sorted and oversized arrays chunked, as Flax's serializer
    leaves the tree before packing it."""
    if isinstance(tree, dict):
        return {k: _prepare(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """Flax's ``msgpack_serialize`` of a nested dict of numpy arrays."""
    return _pack(_prepare(tree))


def save_params(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts with str keys, numpy arrays and
    scalars) as Flax msgpack to ``path``."""
    with open(path, "wb") as fh:
        fh.write(msgpack_serialize(tree))
