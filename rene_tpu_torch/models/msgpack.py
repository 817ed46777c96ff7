"""Reader and writer of the U-Net weight files of rene_tpu, with no package.

`UNetDenoiser.save` (rene_tpu/models/denoise.py:177-186) writes two header
bytes (features, levels), then flax's msgpack of the parameter tree
(`flax.serialization.to_bytes`): maps with str keys down to the leaves,
each leaf an ndarray as msgpack ext type 1 whose data is itself the
msgpack of (shape, dtype name, C-order bytes). The decoder covers the
forms such a file uses (map, str, bin, array, unsigned int and ext, each
in its fix/8/16/32 forms) and raises ValueError on any other type byte, so
a file of another kind fails loudly. The encoder, `packb`, is its
inverse: it writes the same objects in msgpack's shortest form of each,
as flax's encoder does, and raises ValueError on any other object.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

EXT_NDARRAY = 1     # flax.serialization._MsgpackExtType.ndarray


def _n(data: bytes, pos: int, size: int) -> Tuple[int, int]:
    """A big-endian unsigned int of `size` bytes at `pos`, and the end."""
    end = pos + size
    if end > len(data):
        raise ValueError("msgpack: truncated")
    return int.from_bytes(data[pos:end], "big"), end


def _take(data: bytes, pos: int, size: int) -> Tuple[bytes, int]:
    end = pos + size
    if end > len(data):
        raise ValueError("msgpack: truncated")
    return data[pos:end], end


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, raw = unpackb(data)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


# the fix forms: a range of type bytes whose low bits hold the value or
# the length; the sized forms: the bytes of the value or length that
# follow the type byte; fixext: the data's length
_FIX = ((0x00, 0x7f, "uint"), (0x80, 0x8f, "map"), (0x90, 0x9f, "array"),
        (0xa0, 0xbf, "str"))
_SIZED = {0xcc: ("uint", 1), 0xcd: ("uint", 2), 0xce: ("uint", 4),
          0xd9: ("str", 1), 0xda: ("str", 2),
          0xdb: ("str", 4), 0xc4: ("bin", 1), 0xc5: ("bin", 2),
          0xc6: ("bin", 4), 0xdc: ("array", 2), 0xdd: ("array", 4),
          0xde: ("map", 2), 0xdf: ("map", 4), 0xc7: ("ext", 1),
          0xc8: ("ext", 2), 0xc9: ("ext", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _decode(data: bytes, pos: int):
    if pos >= len(data):
        raise ValueError("msgpack: truncated")
    t = data[pos]
    pos += 1
    for lo, hi, kind in _FIX:
        if lo <= t <= hi:
            n = t - lo
            break
    else:
        if t in _SIZED:
            kind, size = _SIZED[t]
            n, pos = _n(data, pos, size)
        elif t in _FIXEXT:
            kind, n = "ext", _FIXEXT[t]
        else:
            raise ValueError(f"msgpack: type byte 0x{t:02x} at {pos - 1} "
                             "is not one of the forms this reader covers")
    if kind == "uint":
        return n, pos
    if kind in ("str", "bin"):
        raw, pos = _take(data, pos, n)
        return (raw.decode() if kind == "str" else raw), pos
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _decode(data, pos)
            items.append(v)
        return items, pos
    if kind == "map":
        out = {}
        for _ in range(n):
            k, pos = _decode(data, pos)
            v, pos = _decode(data, pos)
            out[k] = v
        return out, pos
    code, pos = _n(data, pos, 1)        # ext: its type, then n bytes
    raw, pos = _take(data, pos, n)
    if code != EXT_NDARRAY:
        raise ValueError(f"msgpack: ext type {code} is not an ndarray")
    return _ndarray(raw), pos


def _head(out: bytearray, n: int, fix, sized) -> None:
    """A type byte with a length or value `n`: the fix form (its base and
    its largest n) where n fits it, else the first of the sized forms
    ((type byte, bytes of n), ...) that holds n."""
    if fix is not None and n <= fix[1]:
        out.append(fix[0] + n)
        return
    for t, size in sized:
        if n < 1 << (8 * size):
            out.append(t)
            out += n.to_bytes(size, "big")
            return
    raise ValueError(f"msgpack: {n} is too large")


def _ndarray_bytes(a: np.ndarray) -> bytes:
    a = np.asarray(a)
    if a.dtype.hasobject:
        raise ValueError(f"msgpack: ndarray of {a.dtype}")
    return packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def _encode(obj, out: bytearray) -> None:
    if isinstance(obj, dict):
        _head(out, len(obj), (0x80, 15), ((0xde, 2), (0xdf, 4)))
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    elif isinstance(obj, str):
        raw = obj.encode()
        _head(out, len(raw), (0xa0, 31), ((0xd9, 1), (0xda, 2), (0xdb, 4)))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, len(obj), None, ((0xc4, 1), (0xc5, 2), (0xc6, 4)))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), (0x90, 15), ((0xdc, 2), (0xdd, 4)))
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, (int, np.integer)) and not isinstance(obj, bool) \
            and obj >= 0:
        _head(out, int(obj), (0x00, 0x7f),
              ((0xcc, 1), (0xcd, 2), (0xce, 4), (0xcf, 8)))
    elif isinstance(obj, np.ndarray):
        raw = _ndarray_bytes(obj)
        fixext = {v: k for k, v in _FIXEXT.items()}
        if len(raw) in fixext:
            out.append(fixext[len(raw)])
        else:
            _head(out, len(raw), None, ((0xc7, 1), (0xc8, 2), (0xc9, 4)))
        out.append(EXT_NDARRAY)
        out += raw
    else:
        raise ValueError(f"msgpack: {type(obj).__name__} is not one of the "
                         "forms this writer covers")


def packb(obj) -> bytes:
    """The msgpack bytes of `obj`: dicts, str, bytes, lists and tuples,
    unsigned ints and numpy ndarrays (ext type 1), as flax writes them."""
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def unpackb(data: bytes):
    """The object that `data` holds whole (ValueError on trailing bytes)."""
    obj, pos = _decode(bytes(data), 0)
    if pos != len(data):
        raise ValueError(f"msgpack: {len(data) - pos} trailing bytes")
    return obj


def read_weights(path: str):
    """(features, levels, parameter tree) of a `UNetDenoiser.save` file."""
    with open(path, "rb") as f:
        head = f.read(2)
        blob = f.read()
    if len(head) != 2:
        raise ValueError(f"{path}: no header")
    return head[0], head[1], unpackb(blob)


def write_weights(path: str, features: int, levels: int, tree) -> None:
    """A `UNetDenoiser.save` file: the header bytes, then `packb(tree)`."""
    blob = packb(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(bytes([features, levels]))
        f.write(blob)

