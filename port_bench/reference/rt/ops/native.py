"""Frozen copy of rene_tpu_torch/ops/native.py at commit ed2dcef; its library
built under build/port_bench/ of the checkout.

ctypes loader for the native (C++) runtime components.

The shared library is compiled on first use with g++ (no pybind11 in this
image; the C ABI + ctypes keeps the binding dependency-free). Falls back to
pure-numpy implementations when the toolchain is unavailable.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("rene_tpu_torch.native")

# sources in rene_tpu_torch/native/, library in build/rene_tpu_torch/ of
# the checkout
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRCS = [os.path.join(_PKG, "native", f)
         for f in ("bvh_builder.cpp", "piz_huf.cpp")]
_SRC = _SRCS[0]
_LIB = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_PKG))), "build", "port_bench",
                    "librene_native.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _compile() -> bool:
    # build beside the library and rename, so that processes building at
    # once never load a half-written file
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = (["g++", "-O3", "-fPIC", "-shared", "-std=c++17"] + _SRCS
           + ["-o", tmp])
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception as e:  # toolchain missing or compile failure
        log.warning("native build failed (%s); using numpy fallback", e)
        return False


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not all(os.path.exists(s) for s in _SRCS):
            return None
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < max(os.path.getmtime(s)
                                                for s in _SRCS)):
            if not _compile():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as e:
            log.warning("native load failed (%s)", e)
            return None
        lib.rene_build_bvh.restype = ctypes.c_int32
        lib.rene_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.rene_huf_decode.restype = ctypes.c_int32
        lib.rene_huf_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16),
        ]
        _lib = lib
        return _lib


def native_build_bvh(tri_p: np.ndarray, leaf_size: int):
    """Binned-SAH build via the C++ library; None if unavailable.

    Returns (aabb_min, aabb_max, left, right, is_leaf, order) trimmed to the
    actual node count.
    """
    lib = get_lib()
    if lib is None:
        return None
    tri = np.ascontiguousarray(tri_p, dtype=np.float32).reshape(-1, 9)
    n = tri.shape[0]
    max_nodes = max(2 * n - 1, 1)
    aabb_min = np.zeros((max_nodes, 3), np.float32)
    aabb_max = np.zeros((max_nodes, 3), np.float32)
    left = np.zeros(max_nodes, np.int32)
    right = np.zeros(max_nodes, np.int32)
    is_leaf = np.zeros(max_nodes, np.uint8)
    order = np.zeros(n, np.int32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n_nodes = lib.rene_build_bvh(
        p(tri, ctypes.c_float), n, leaf_size,
        p(aabb_min, ctypes.c_float), p(aabb_max, ctypes.c_float),
        p(left, ctypes.c_int32), p(right, ctypes.c_int32),
        p(is_leaf, ctypes.c_uint8), p(order, ctypes.c_int32))
    if n_nodes <= 0:
        return None
    return (aabb_min[:n_nodes], aabb_max[:n_nodes], left[:n_nodes],
            right[:n_nodes], is_leaf[:n_nodes].astype(bool), order)


def native_huf_decode(data: bytes, n_out: int):
    """PIZ canonical-Huffman decode via the C++ library; None if
    unavailable, raises ValueError on a corrupt stream."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros(n_out, np.uint16)
    rc = lib.rene_huf_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(data)), ctypes.c_int64(n_out),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError(f"bad PIZ huffman stream (native rc={rc})")
    return out
