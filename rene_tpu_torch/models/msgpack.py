"""Reader of the U-Net weight files that rene_tpu writes, with no package.

`UNetDenoiser.save` (rene_tpu/models/denoise.py:177-186) writes two header
bytes (features, levels), then flax's msgpack of the parameter tree
(`flax.serialization.to_bytes`): maps with str keys down to the leaves,
each leaf an ndarray as msgpack ext type 1 whose data is itself the
msgpack of (shape, dtype name, C-order bytes). This decoder covers the
forms such a file uses (map, str, bin, array, unsigned int and ext, each
in its fix/8/16/32 forms) and raises ValueError on any other type byte, so
a file of another kind fails loudly.
"""
from __future__ import annotations

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

