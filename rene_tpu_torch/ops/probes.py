"""Plain versions of the probe kernels (csrc/probes.cu): the last two
Mosaic probes of the reference's TPU probe scripts.

P-r3n (scripts/tpu_session_r3n.py :46-66): an (8, 128) block of a
geometry table picked by a group index read at run time from a box
table. P-r3w (scripts/tpu_session_r3w.py :67-99): a (384, 8) @ (8, 1024)
float32 product at two precisions against a chain of scalar
multiply-adds. The tables and inputs are the scripts' own, made with
numpy from the same seeds.
"""
from __future__ import annotations

import numpy as np
import torch

R3N_GROUPS, R3N_GROWS, R3N_LANES = 16, 2, 128
R3N_MODES = (1, 2, 3)     # k_p1 astype, k_p2 bitcast, k_p3 octant
R3N_SIS = (0, 3, R3N_GROUPS - 1)   # the groups the script checks
R3W_REPS, R3W_STEPS, R3W_K = 200, 32, 8
R3W_KINDS = ("hi", "def", "vpu")


def r3n_tables():
    """(perm, box, geom) of tpu_session_r3n.py :37-44: group i's box row
    2i holds perm[i] as a float in column 126 and as int32 bits in column
    127; geom's 128-column block j is filled with j."""
    perm = np.random.default_rng(0).permutation(R3N_GROUPS)
    box = np.zeros((R3N_GROUPS * R3N_GROWS, R3N_LANES), np.float32)
    box[::R3N_GROWS, 126] = perm.astype(np.float32)
    box[::R3N_GROWS, 127] = perm.astype(np.int32).view(np.float32)
    geom = np.zeros((8, R3N_GROUPS * R3N_LANES), np.float32)
    for j in range(R3N_GROUPS):
        geom[:, j * R3N_LANES:(j + 1) * R3N_LANES] = float(j)
    return perm, torch.from_numpy(box), torch.from_numpy(geom)


def _clamp(x: int, lo: int, hi: int) -> int:
    return min(max(x, lo), hi)


def rowslice_ref(mode: int, si: int, box: torch.Tensor,
                 geom: torch.Tensor) -> torch.Tensor:
    """P-r3n: geom[:, g*128:(g+1)*128] for the group index g that probe
    `mode` reads for group si (csrc/probes.cuh rowslice_group): box[2 si,
    126] truncated to int (k_p1), the int32 bits of box[2 si, 127] (k_p2),
    or k_p1's after offsetting si by 7 * (geom[0, 0] - 3 < 0) - 7 (k_p3's
    octant). Slice starts past a table's end clamp into it, as
    lax.dynamic_slice clamps."""
    if mode not in R3N_MODES:
        raise ValueError(f"mode {mode}: one of {R3N_MODES}")
    if mode == 3:
        neg = int(bool(geom[0, 0] - 3.0 < 0))
        si = si + (4 * neg + 2 * neg + neg) - 7
    row = _clamp(si * R3N_GROWS, 0, box.shape[0] - R3N_GROWS)
    if mode == 2:
        g = int(box[row, 127:128].view(torch.int32))
    else:
        g = int(box[row, 126].to(torch.int32))
    g = _clamp(g, 0, geom.shape[1] // R3N_LANES - 1)
    return geom[:, g * R3N_LANES:(g + 1) * R3N_LANES].clone()


def r3w_inputs():
    """(B, R) of tpu_session_r3w.py :40-42: (384, 8) and (8, 1024)
    standard normal float32 from default_rng(0)."""
    g = np.random.default_rng(0)
    b = g.standard_normal((384, 8)).astype(np.float32)
    r = g.standard_normal((8, 1024)).astype(np.float32)
    return torch.from_numpy(b), torch.from_numpy(r)


def m4_inputs():
    """(tri, o, d) of tpu_session_r3w.py's M4 (:111-115): 40 triangles
    and 16 rays drawn from default_rng(0) after B and R."""
    g = np.random.default_rng(0)
    g.standard_normal((384, 8))
    g.standard_normal((8, 1024))
    tri = g.standard_normal((40, 3, 3)).astype(np.float32)
    o = g.standard_normal((16, 3)).astype(np.float32) * 0.1
    d = g.standard_normal((16, 3)).astype(np.float32)
    return tri, o, d


def m4_hits(sides: np.ndarray, padded: int, ntri: int) -> np.ndarray:
    """(ntri, N) hits from the (3 padded, N) side values: all three of
    the same sign (tpu_session_r3w.py :120-124)."""
    s0 = sides[:padded][:ntri]
    s1 = sides[padded:2 * padded][:ntri]
    s2 = sides[2 * padded:][:ntri]
    return (((s0 >= 0) & (s1 >= 0) & (s2 >= 0))
            | ((s0 <= 0) & (s1 <= 0) & (s2 <= 0)))


def m4_mt_hits(tri: np.ndarray, o: np.ndarray, d: np.ndarray) -> np.ndarray:
    """(ntri, N) hits of the script's float32 numpy Möller–Trumbore loop
    (:125-137; no tmin or tmax)."""
    hit = np.zeros((tri.shape[0], o.shape[0]), bool)
    for ti in range(tri.shape[0]):
        v0, v1, v2 = tri[ti]
        e1, e2 = v1 - v0, v2 - v0
        p = np.cross(d, np.broadcast_to(e2, d.shape))
        det = (e1 * p).sum(1)
        tv = o - v0
        u = (tv * p).sum(1) / det
        q = np.cross(tv, np.broadcast_to(e1, d.shape))
        v = (d * q).sum(1) / det
        hit[ti] = (np.abs(det) > 1e-12) & (u >= -1e-5) & (v >= -1e-5) & \
            (u + v <= 1 + 1e-5)
    return hit


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even), back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def product_scale(b: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """|b| @ |r|, the scale a product's error is measured against."""
    return (b.double().abs() @ r.double().abs()).float()


def mxu_ref(kind: str, b: torch.Tensor, r: torch.Tensor,
            reps: int = R3W_REPS) -> torch.Tensor:
    """P-r3w, the last of `reps` runs. "hi" (k_mxu_hi, HIGHEST): b @ r
    accumulated in float64, rounded to float32. "def" (k_mxu_def, the
    default precision): the product of b and r rounded to bfloat16,
    accumulated in float64. "vpu" (k_vpu): x = r[0] as (8, 128) * 0 + 1,
    then `reps` runs of 32 steps of six operations with c0 = b[0, k] and
    c1 = b[1, k], k clamped to column 7 as JAX's interpret mode clamps
    the reference's index (ROADMAP Queue 3 (g))."""
    if kind == "hi":
        return (b.double() @ r.double()).float()
    if kind == "def":
        return (bf16(b).double() @ bf16(r).double()).float()
    if kind != "vpu":
        raise ValueError(f"kind {kind!r}: one of {R3W_KINDS}")
    x = r[0, :8 * 128].reshape(8, 128) * 0.0 + 1.0
    cs = [(b[0, min(k, R3W_K - 1)], b[1, min(k, R3W_K - 1)])
          for k in range(R3W_STEPS)]
    for _ in range(reps):
        for c0, c1 in cs:
            x = x * c0 + c1
            x = torch.minimum(x * c1 + c0, x)
            x = x * c0 + c1
            x = torch.maximum(x, x * c1)
            x = x * c0 + c1
            x = torch.minimum(x, x * c1 + c0)
    return x


def mxu_flops(kind: str, b: torch.Tensor, r: torch.Tensor) -> float:
    """Operations of one rep: 2 m n k for a product (three passes for
    "hi"'s 3xTF32 split), 14 per lane and step for "vpu" (six products,
    five sums, three min/max)."""
    if kind == "vpu":
        return 8 * 128 * R3W_STEPS * 14
    m, k = b.shape
    return 2.0 * m * r.shape[1] * k * (3 if kind == "hi" else 1)
