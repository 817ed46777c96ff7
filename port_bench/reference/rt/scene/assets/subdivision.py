"""Frozen copy of rene_tpu_torch/scene/assets/subdivision.py at commit ed2dcef.

Uniform Loop subdivision (replaces the reference's OpenSubdiv C++ FFI).

The reference calls opensubdiv-petite with scheme=Loop and uniform refinement
(rene/src/scene/subdivision.rs:25-76), discards normals/uvs,
and regenerates smooth normals by area-weighted face-normal accumulation.
This is a self-contained numpy implementation of the standard Loop scheme:

* each triangle splits into 4;
* new edge points: 3/8 (a+b) + 1/8 (c+d) for interior edges (c, d the
  opposite vertices of the two adjacent faces), 1/2 (a+b) for boundaries;
* old vertex points: (1-n*beta) v + beta * sum(neighbors), with Loop's
  beta = 1/n (5/8 - (3/8 + 1/4 cos(2 pi/n))^2); boundary vertices use
  1/8 (left+right) + 3/4 v.
"""
from __future__ import annotations

import numpy as np

from .ply import TriangleMesh


def _subdivide_once(positions: np.ndarray, indices: np.ndarray):
    V = len(positions)
    tris = indices.reshape(-1, 3).astype(np.int64)
    F = len(tris)

    # Edge table: undirected edges with adjacent opposite vertices.
    ea = tris[:, [0, 1, 2]].reshape(-1)
    eb = tris[:, [1, 2, 0]].reshape(-1)
    eo = tris[:, [2, 0, 1]].reshape(-1)  # opposite vertex per half-edge
    lo = np.minimum(ea, eb)
    hi = np.maximum(ea, eb)
    key = lo * V + hi
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    E = len(uniq)
    e_lo = uniq // V
    e_hi = uniq % V

    # Sum of opposite vertices per edge and boundary detection.
    opp_sum = np.zeros((E, 3), dtype=np.float64)
    np.add.at(opp_sum, inv, positions[eo])
    boundary = counts == 1

    edge_pts = np.where(
        boundary[:, None],
        0.5 * (positions[e_lo] + positions[e_hi]),
        0.375 * (positions[e_lo] + positions[e_hi]) + 0.125 * opp_sum)

    # Old vertex smoothing.
    valence = np.zeros(V, dtype=np.int64)
    nbr_sum = np.zeros((V, 3), dtype=np.float64)
    np.add.at(valence, e_lo, 1)
    np.add.at(valence, e_hi, 1)
    np.add.at(nbr_sum, e_lo, positions[e_hi])
    np.add.at(nbr_sum, e_hi, positions[e_lo])

    on_boundary = np.zeros(V, dtype=bool)
    on_boundary[e_lo[boundary]] = True
    on_boundary[e_hi[boundary]] = True
    bnd_sum = np.zeros((V, 3), dtype=np.float64)
    bnd_cnt = np.zeros(V, dtype=np.int64)
    np.add.at(bnd_sum, e_lo[boundary], positions[e_hi[boundary]])
    np.add.at(bnd_sum, e_hi[boundary], positions[e_lo[boundary]])
    np.add.at(bnd_cnt, e_lo[boundary], 1)
    np.add.at(bnd_cnt, e_hi[boundary], 1)

    n = np.maximum(valence, 1).astype(np.float64)
    beta = (1.0 / n) * (0.625 - (0.375 + 0.25 * np.cos(2 * np.pi / n)) ** 2)
    interior = (1 - n * beta)[:, None] * positions + beta[:, None] * nbr_sum
    bnd = 0.75 * positions + 0.125 * bnd_sum
    new_old = np.where(on_boundary[:, None] & (bnd_cnt == 2)[:, None],
                       bnd, interior)

    new_pos = np.concatenate([new_old, edge_pts], axis=0)

    # New topology: per face, edge-midpoint indices m01, m12, m20.
    m = (inv + V).reshape(F, 3)  # inv order matches (v0v1, v1v2, v2v0)
    t0 = np.stack([tris[:, 0], m[:, 0], m[:, 2]], axis=1)
    t1 = np.stack([tris[:, 1], m[:, 1], m[:, 0]], axis=1)
    t2 = np.stack([tris[:, 2], m[:, 2], m[:, 1]], axis=1)
    t3 = m
    new_idx = np.concatenate([t0, t1, t2, t3], axis=0).reshape(-1)
    return new_pos, new_idx


def generate_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth normals (reference subdivision.rs:7-23)."""
    tris = indices.reshape(-1, 3).astype(np.int64)
    a = positions[tris[:, 0]]
    b = positions[tris[:, 1]]
    c = positions[tris[:, 2]]
    fn = np.cross(b - a, c - a)
    normals = np.zeros_like(positions, dtype=np.float64)
    for k in range(3):
        np.add.at(normals, tris[:, k], fn)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.maximum(norm, 1e-20)).astype(np.float32)


def loop_subdivision(mesh: TriangleMesh, level: int) -> TriangleMesh:
    pos = mesh.positions.astype(np.float64)
    idx = mesh.indices.astype(np.int64)
    for _ in range(max(level, 0)):
        pos, idx = _subdivide_once(pos, idx)
    normals = generate_normals(pos, idx)
    uvs = np.zeros((len(pos), 2), dtype=np.float32)
    return TriangleMesh(pos.astype(np.float32), normals, uvs,
                        idx.astype(np.uint32))
