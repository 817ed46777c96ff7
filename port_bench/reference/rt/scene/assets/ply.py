"""Frozen copy of rene_tpu_torch/scene/assets/ply.py at commit ed2dcef.

PLY mesh loader (ascii / binary little+big endian), numpy-vectorized.

Behavioral parity with the reference's ply-rs based loader
(rene/src/scene/intermediate_scene.rs:679-752):
reads vertex x/y/z, optional nx/ny/nz (else zero normals), optional u/v
(else zero uv); triangle faces kept, quads split (0,1,2)+(0,2,3); any other
face arity is an error.
"""
from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


class PlyError(Exception):
    pass


class TriangleMesh:
    """Flat triangle mesh: vertices (V,3/3/2), indices (F*3,) uint32."""

    def __init__(self, positions, normals, uvs, indices):
        self.positions = np.asarray(positions, dtype=np.float32).reshape(-1, 3)
        self.normals = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
        self.uvs = np.asarray(uvs, dtype=np.float32).reshape(-1, 2)
        self.indices = np.asarray(indices, dtype=np.uint32).reshape(-1)
        if self.indices.size % 3 != 0:
            raise PlyError("indices not a multiple of 3")
        if self.indices.size and self.indices.max() >= len(self.positions):
            raise PlyError("index out of range")

    @property
    def num_triangles(self) -> int:
        return self.indices.size // 3


def _parse_header(data: bytes):
    end = data.find(b"end_header\n")
    if end < 0:
        raise PlyError("no end_header")
    header = data[:end].decode("ascii", errors="replace")
    body = data[end + len(b"end_header\n"):]
    fmt = None
    elements = []  # (name, count, [(prop_kind, dtype, name) ...])
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", (parts[2], parts[3]), parts[4]))
            else:
                elements[-1][2].append(("scalar", parts[1], parts[2]))
    if fmt is None:
        raise PlyError("no format line")
    return fmt, elements, body


def _np_dtype(name: str, endian: str) -> np.dtype:
    if name not in _PLY_DTYPES:
        raise PlyError(f"unknown ply type {name}")
    base = _PLY_DTYPES[name]
    if base in ("i1", "u1"):
        return np.dtype(base)
    return np.dtype(endian + base)


def _load_binary(elements, body, endian):
    out = {}
    offset = 0
    for name, count, props in elements:
        if all(p[0] == "scalar" for p in props):
            dt = np.dtype([(p[2], _np_dtype(p[1], endian)) for p in props])
            arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
            offset += dt.itemsize * count
            out[name] = ("scalar", arr)
        else:
            # list element (faces). Fast path: uniform list length probe.
            if len(props) != 1 or props[0][0] != "list":
                raise PlyError("mixed list/scalar element unsupported")
            cnt_t, idx_t = props[0][1]
            cnt_dt = _np_dtype(cnt_t, endian)
            idx_dt = _np_dtype(idx_t, endian)
            if count == 0:
                out[name] = ("list", [])
                continue
            n0 = int(np.frombuffer(body, dtype=cnt_dt, count=1,
                                   offset=offset)[0])
            stride = cnt_dt.itemsize + n0 * idx_dt.itemsize
            uniform = False
            if offset + stride * count <= len(body):
                raw = np.frombuffer(body, dtype=np.uint8, count=stride * count,
                                    offset=offset).reshape(count, stride)
                counts = raw[:, :cnt_dt.itemsize].copy().view(cnt_dt)[:, 0]
                uniform = bool((counts == n0).all())
            if uniform:
                idx = raw[:, cnt_dt.itemsize:].copy().view(idx_dt)
                out[name] = ("uniform_list", (n0, idx.astype(np.int64)))
                offset += stride * count
            else:
                faces = []
                for _ in range(count):
                    n = int(np.frombuffer(body, dtype=cnt_dt, count=1,
                                          offset=offset)[0])
                    offset += cnt_dt.itemsize
                    f = np.frombuffer(body, dtype=idx_dt, count=n,
                                      offset=offset)
                    offset += idx_dt.itemsize * n
                    faces.append(f.astype(np.int64))
                out[name] = ("list", faces)
    return out


def _load_ascii(elements, body):
    lines = body.decode("ascii").split("\n")
    li = 0
    out = {}
    for name, count, props in elements:
        if all(p[0] == "scalar" for p in props):
            rows = np.array(
                [lines[li + i].split() for i in range(count)], dtype=np.float64)
            li += count
            names = [p[2] for p in props]
            dt = np.dtype([(n, "f8") for n in names])
            arr = np.zeros(count, dtype=dt)
            for j, n in enumerate(names):
                arr[n] = rows[:, j]
            out[name] = ("scalar", arr)
        else:
            faces = []
            for i in range(count):
                vals = [int(x) for x in lines[li + i].split()]
                faces.append(np.array(vals[1:1 + vals[0]], dtype=np.int64))
            li += count
            out[name] = ("list", faces)
    return out


def load_ply(path: str) -> TriangleMesh:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"ply"):
        raise PlyError("not a ply file")
    fmt, elements, body = _parse_header(data)
    if fmt == "binary_little_endian":
        parsed = _load_binary(elements, body, "<")
    elif fmt == "binary_big_endian":
        parsed = _load_binary(elements, body, ">")
    elif fmt == "ascii":
        parsed = _load_ascii(elements, body)
    else:
        raise PlyError(f"unknown format {fmt}")

    if "vertex" not in parsed or "face" not in parsed:
        raise PlyError("missing vertex/face elements")
    _, verts = parsed["vertex"]
    names = verts.dtype.names
    for req in ("x", "y", "z"):
        if req not in names:
            raise PlyError(f"vertex missing {req}")
    pos = np.stack([verts["x"], verts["y"], verts["z"]], axis=-1)
    if all(n in names for n in ("nx", "ny", "nz")):
        nrm = np.stack([verts["nx"], verts["ny"], verts["nz"]], axis=-1)
    else:
        nrm = np.zeros_like(pos)
    if "u" in names and "v" in names:
        uv = np.stack([verts["u"], verts["v"]], axis=-1)
    elif "s" in names and "t" in names:
        uv = np.stack([verts["s"], verts["t"]], axis=-1)
    else:
        uv = np.zeros((len(pos), 2), dtype=np.float32)

    kind, payload = parsed["face"]
    if kind == "uniform_list":
        n, idx = payload
        if n == 3:
            indices = idx.reshape(-1)
        elif n == 4:
            tri = np.concatenate(
                [idx[:, [0, 1, 2]], idx[:, [0, 2, 3]]], axis=1)
            indices = tri.reshape(-1)
        else:
            raise PlyError(f"unsupported face len {n}")
    else:
        chunks = []
        for f in payload:
            if len(f) == 3:
                chunks.append(f)
            elif len(f) == 4:
                chunks.append(f[[0, 1, 2]])
                chunks.append(f[[0, 2, 3]])
            else:
                raise PlyError(f"unsupported face len {len(f)}")
        indices = (np.concatenate(chunks) if chunks
                   else np.zeros(0, dtype=np.int64))
    return TriangleMesh(pos, nrm, uv, indices)
