"""Reader and writer of flax's msgpack checkpoints, in the standard library
and numpy.

The JAX package writes its network variables with
``flax.serialization.to_bytes``: a msgpack map of maps whose leaves are
numpy arrays in msgpack extension types.  The port reads and writes those
files without flax or msgpack:

  * msgpack: maps, arrays, str, bin, nil, bool, ints, float32/float64,
    and extension types (the whole format but timestamps);
  * flax's extensions: 1 = ndarray, itself msgpack of
    ``(shape, dtype name, C-order bytes)``; 2 = complex, msgpack of
    ``(real, imag)``; 3 = numpy scalar, packed as a 0-d ndarray.

``msgpack_restore`` gives what ``flax.serialization.msgpack_restore``
gives: nested dicts with numpy leaves, bit for bit
(tests/test_torch_zero_net.py).  ``packb`` packs such a tree with
msgpack's shortest encodings and flax's ndarray extension, map keys
sorted (it packs only what a checkpoint holds): the
bytes ``flax.serialization.msgpack_serialize`` gives for the tree with its
keys sorted, which ``flax.serialization.from_bytes`` restores into the JAX
package's train state bit for bit (tests/test_torch_zero_learn.py).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        fixed = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: self.take(self.unpack("B")),
            0xC5: lambda: self.take(self.unpack("H")),
            0xC6: lambda: self.take(self.unpack("I")),
            0xC7: lambda: self.ext(self.unpack("B")),
            0xC8: lambda: self.ext(self.unpack("H")),
            0xC9: lambda: self.ext(self.unpack("I")),
            0xCA: lambda: self.unpack("f"), 0xCB: lambda: self.unpack("d"),
            0xCC: lambda: self.unpack("B"), 0xCD: lambda: self.unpack("H"),
            0xCE: lambda: self.unpack("I"), 0xCF: lambda: self.unpack("Q"),
            0xD0: lambda: self.unpack("b"), 0xD1: lambda: self.unpack("h"),
            0xD2: lambda: self.unpack("i"), 0xD3: lambda: self.unpack("q"),
            0xD4: lambda: self.ext(1), 0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4), 0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.take(self.unpack("B")).decode(),
            0xDA: lambda: self.take(self.unpack("H")).decode(),
            0xDB: lambda: self.take(self.unpack("I")).decode(),
            0xDC: lambda: self.array(self.unpack("H")),
            0xDD: lambda: self.array(self.unpack("I")),
            0xDE: lambda: self.map(self.unpack("H")),
            0xDF: lambda: self.map(self.unpack("I")),
        }
        if b not in fixed:
            raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")
        return fixed[b]()

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack("b")
        payload = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            re, im = unpackb(payload)
            return complex(re, im)
        raise ValueError(f"msgpack: unknown extension type {code}")


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(_shape(shape), order="C")


def _shape(shape) -> Tuple[int, ...]:
    return tuple(int(d) for d in shape)


def unpackb(data: bytes) -> Any:
    """One msgpack value from ``data``, which it must fill exactly."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes")
    return out


def msgpack_restore(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` gives for ``data``."""
    tree = unpackb(data)
    _refuse_chunked(tree)
    return tree


def _refuse_chunked(tree: Any) -> None:
    # flax splits arrays above 2**30 bytes into chunks; no network of this
    # repository comes near that size
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError("chunked msgpack arrays (over 1 GiB) are not supported")
        for v in tree.values():
            _refuse_chunked(v)


def read_checkpoint(path: str) -> Any:
    """The variable tree of a flax checkpoint file."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# ------------------------------------------------------------ writer

_MAX_ARRAY_BYTES = 2 ** 30  # flax chunks arrays above this size


def _sized(out: list, n: int, small: Tuple[int, int], codes: Tuple[int, ...]) -> None:
    """The header of a str, bin, array or map of length ``n``: ``small`` =
    (fixed-format base, its limit) or (−1, 0) when there is none; ``codes``
    the 8-, 16- and 32-bit length formats (0 where the 8-bit one does not
    exist)."""
    base, limit = small
    if base >= 0 and n <= limit:
        out.append(struct.pack(">B", base | n))
    elif codes[0] and n <= 0xFF:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack: length {n} does not fit")


def _uint(out: list, v: int) -> None:
    for code, fmt, top in ((-1, "B", 0x7F), (0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF),
                           (0xCE, "I", 0xFFFFFFFF), (0xCF, "Q", 2 ** 64 - 1)):
        if 0 <= v <= top:
            out.append(struct.pack(">" + fmt, v) if code < 0 else struct.pack(">B" + fmt, code, v))
            return
    raise ValueError(f"msgpack: {v} is not a non-negative int that fits")


def _ext(out: list, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack(">B", fixed[n]))
    else:
        _sized(out, n, (-1, 0), (0xC7, 0xC8, 0xC9))
    out.append(struct.pack(">b", code))
    out.append(payload)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"msgpack: cannot pack arrays of dtype {arr.dtype}")
    if arr.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError("chunked msgpack arrays (over 1 GiB) are not supported")
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: list, v: Any) -> None:
    """What a checkpoint holds: maps with str keys, ndarray leaves, and the
    ndarray extension's (shape, dtype name, bytes) payload."""
    if isinstance(v, np.ndarray):
        _ext(out, _EXT_NDARRAY, _ndarray_bytes(v))
    elif isinstance(v, int) and not isinstance(v, bool):
        _uint(out, v)
    elif isinstance(v, str):
        data = v.encode()
        _sized(out, len(data), (0xA0, 31), (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(v, bytes):
        _sized(out, len(v), (-1, 0), (0xC4, 0xC5, 0xC6))
        out.append(v)
    elif isinstance(v, tuple):
        _sized(out, len(v), (0x90, 15), (0, 0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif isinstance(v, dict):
        _sized(out, len(v), (0x80, 15), (0, 0xDE, 0xDF))
        for key in sorted(v):
            _pack(out, key)
            _pack(out, v[key])
    else:
        raise TypeError(f"msgpack: cannot pack {type(v).__name__}")


def packb(value: Any) -> bytes:
    """``value`` (nested dicts with str keys and numpy array leaves) as
    msgpack bytes: shortest encodings, map keys sorted, flax's ndarray
    extension."""
    out: list = []
    _pack(out, value)
    return b"".join(out)


def write_checkpoint(path: str, tree: Any) -> None:
    """Write a variable tree (nested dicts with numpy leaves) as a flax
    checkpoint file."""
    with open(path, "wb") as f:
        f.write(packb(tree))
