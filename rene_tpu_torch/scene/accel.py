"""Acceleration tables for scenes past the immediates budget (K1c, K1d).

Counterpart of what rene_tpu/integrators/pallas_path.py packs for its
big-mesh march and sphere table, with the TPU layout replaced:

* the world mesh (`_pack_mesh` :805 -> `_pack_tris` :839): the JAX kernel
  keeps the non-immediate triangles in Morton- or median-ordered 128-
  triangle clusters behind super-group and octant box tables, because
  Mosaic can only march all lanes of a tile in lock-step over slices of
  a VMEM table. A CUDA thread walks its own tree, so the port keeps
  them in the binned-SAH BVH that `ops.bvh.build_bvh` builds (the
  port's copy of rene_tpu/ops/bvh.py's builder: the native C++ builder,
  compiled at first use, or numpy median splits);
* shared-BLAS instances (`_shared_split` :961, `_pack_inst_mesh` :1000):
  one object-space BVH per shared BLAS, and one row per instance with
  its world-to-object affine, material slot and BLAS root;
* the sphere table (`_sph_uniform` :1189, `_pack_sphere_table` :1203):
  centre, radius and material slot of each non-emissive uniform-scale
  sphere,
  in the same Morton order and 128-slot blocks, each block behind one
  box.

Every triangle row is the JAX table's: v0, e1 = v1 - v0, e2 = v2 - v0,
the shading normal n0 and its deltas d1 = n1 - n0, d2 = n2 - n0, all
computed in float64 and cast to float32 (`_pack_tris` :861-868), then
the material slot (scene/pack.py `material_slots`: the material with the
media on its two sides, as the JAX packer's `(material, imed, emed)`
records). Where a mesh material reads a texture (`_mesh_needs_uv`
:591) the JAX table grows by six uv rows; here the uv of mesh row k (uv0
and the deltas uv1 - uv0, uv2 - uv0, `_pack_tris` :869-872) go to row k of
a side table `mesh_uv`, 24 bytes per triangle, which only a textured hit
reads, so the rows the walk strides over stay 80 bytes. Row layouts are
shared with csrc/layout.cuh.

The CUDA walk (csrc/bvh.cuh) reads the same BVHs in another form, built
here from the binary ones (`wide_tables`), while the plain version
(ops/bvh.py) and the bounds keep walking the binary nodes:

* each binary BVH collapsed into a 4-wide one (`_collapse`): a wide row
  holds the boxes of up to four children, each a binary node's own box
  in float32, and their walk entries; its leaves are the binary leaves,
  so a mesh row keeps its index;
* `mesh_vt`: the first 12 floats of every mesh row (v0, e1, e2 and three
  zeros), the 48 bytes the triangle test reads, so that a leaf strides
  over no shading rows;
* one small wide tree on top (`top`, by the surface-area heuristic, so
  that the world BVH sits near its root) over the world BVH's root, each
  instance (behind the world box of its BLAS root's box, padded so that
  it holds every ray the object-space root box takes) and each
  SPH_BLOCK-slot block of the sphere table behind its box.

A walk entry is one int32, tag << TAG_SHIFT | payload: a wide node,
a leaf (first mesh row << LEAF_COUNT_BITS | triangles), an instance or a
table block; TAG_MARKER brings a walk back from an instance's object
space. The deepest stack a walk may need is checked against TRAVERSAL_STACK.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .. import trace
from ..ops import bvh as _bvh
from . import types as T

# -- row layouts (mirrored by csrc/layout.cuh) -------------------------------
# BVH node: two float4, (min xyz, left child or first triangle) and
# (max xyz, right child, or minus the triangle count for a leaf)
NODE_LO, NODE_A, NODE_HI, NODE_B = 0, 3, 4, 7
NODE_W = 8
MESH_V0, MESH_E1, MESH_E2 = 0, 3, 6
MESH_N0, MESH_D1, MESH_D2, MESH_MAT = 9, 12, 15, 18
MESH_W = 20
MESH_UV_W = 6       # mesh_uv rows: uv0, uv1 - uv0, uv2 - uv0
INST_W2O, INST_MAT, INST_ROOT = 0, 12, 13   # 3x4 row-major w2o affine
INST_W = 16
SPHT_C, SPHT_R, SPHT_MAT = 0, 3, 4
SPHT_W = 8
BOX_LO, BOX_HI = 0, 4
BOX_W = 8
SPH_BLOCK = 128     # pallas_path.py:66
# the CUDA walk's tables (`wide_tables`): wide nodes of BVH_WIDTH children, per
# child box coordinate one float4 (lo x, hi x, lo y, hi y, lo z, hi z),
# then the four walk entries as int32 bits and four unused floats
BVH_WIDTH = 4
NODE4_LX, NODE4_HX, NODE4_LY, NODE4_HY, NODE4_LZ, NODE4_HZ = (
    0, 4, 8, 12, 16, 20)
NODE4_REF = 24
NODE4_W = 32
VT_W = 12           # mesh_vt rows: v0, e1, e2, 0, 0, 0
INST_WROOT = 14     # the wide root of an instance's BLAS, in its row
TAG_SHIFT = 29
TAG_NODE, TAG_LEAF, TAG_INST, TAG_BLOCK = 0, 1, 2, 3
LEAF_COUNT_BITS = 4
TAG_PAYLOAD = (1 << TAG_SHIFT) - 1
TAG_MARKER = (TAG_INST << TAG_SHIFT) | TAG_PAYLOAD
TAG_EMPTY = -1     # an unused child slot
TRAVERSAL_STACK = 64     # entries of a CUDA thread's walk stack
# the padding of an instance's world box, relative to its size
INST_BOX_PAD = 1e-5

INST_MIN_SAVING = 4096     # pallas_path.py:958
HBM_MIN_TRIS = 1 << 17     # pallas_path.py:99: a shared BLAS's size cap


def shared_split(buffers_np, mesh_idx: np.ndarray):
    """`_shared_split` (pallas_path.py:961): split the non-immediate
    triangles `mesh_idx` into shared-BLAS instance groups and the rest.
    A BLAS is shared when at least two triangle instances reference it,
    each non-emissive with all its triangles in `mesh_idx`, the BLAS has
    at most HBM_MIN_TRIS triangles and sharing saves INST_MIN_SAVING
    triangle slots. Returns (rest_idx, [(blas_id, [inst_ids]), ...])."""
    if "inst_blas" not in buffers_np:
        return mesh_idx, []
    inst_of = buffers_np["tri_inst"][mesh_idx]
    n_inst = buffers_np["inst_prim_count"].shape[0]
    counts = np.bincount(inst_of, minlength=n_inst)
    by_blas: Dict[int, List[int]] = {}
    for i in np.nonzero(counts > 0)[0]:
        b = int(buffers_np["inst_blas"][i])
        if b < 0 or counts[i] != int(buffers_np["inst_prim_count"][i]):
            continue
        al = int(buffers_np["inst_area_light"][i])
        if int(buffers_np["area_type"][al]) != T.AREA_NULL:
            continue
        by_blas.setdefault(b, []).append(int(i))
    shared = []
    for b, insts in sorted(by_blas.items()):
        ntri_b = int(buffers_np["inst_prim_count"][insts[0]])
        if len(insts) < 2 or ntri_b > HBM_MIN_TRIS:
            continue
        if ntri_b * (len(insts) - 1) < INST_MIN_SAVING:
            continue
        shared.append((b, insts))
    if not shared:
        return mesh_idx, []
    keep = ~np.isin(inst_of, [i for _, insts in shared for i in insts])
    return mesh_idx[keep], shared


def sphere_uniform(o2w) -> Tuple[bool, np.ndarray, float]:
    """`_sph_uniform` (pallas_path.py:1189): (ok, centre, radius) when the
    3x4 sphere transform is rigid plus a uniform scale."""
    m = np.asarray(o2w, np.float64)
    a = m[:3, :3]
    g = a.T @ a
    s2 = float(np.trace(g)) / 3.0
    if s2 <= 0 or not np.allclose(g, np.eye(3) * s2, rtol=1e-4,
                                  atol=1e-6 * max(s2, 1e-12)):
        return False, None, 0.0
    return True, m[:3, 3].copy(), float(np.sqrt(s2))


def _morton3(q: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of (N, 3) 10-bit grid coordinates
    (pallas_path.py:749)."""
    def part(v):
        v = v.astype(np.uint64)
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v
    return (part(q[:, 0]) | (part(q[:, 1]) << np.uint64(1))
            | (part(q[:, 2]) << np.uint64(2)))


class _Builder:
    """Appends BVHs over triangle sets to one node table and one
    leaf-ordered triangle table; child and leaf indices are absolute."""

    def __init__(self):
        self.nodes: List[np.ndarray] = []
        self.rows: List[np.ndarray] = []
        self.uvs: List[np.ndarray] = []
        self.n_nodes = self.n_rows = 0
        self.depth = self.max_leaf = 0

    def add(self, p: np.ndarray, n: np.ndarray, mat: np.ndarray,
            uv: np.ndarray = None) -> int:
        """BVH over float64 (T, 3, 3) points p with (T, 3, 3) normals n,
        (T,) material ids and, for a textured mesh, (T, 3, 2) uv; returns
        its root node."""
        bvh = _bvh.build_bvh(p.astype(np.float32))
        m = p.shape[0]
        order = bvh.order[:m].astype(np.int64)
        p, n, mat = p[order], n[order], mat[order]
        if uv is not None:
            uv = uv[order]
            self.uvs.append(np.concatenate(
                [uv[:, 0], uv[:, 1] - uv[:, 0], uv[:, 2] - uv[:, 0]], axis=1))
        rows = np.zeros((m, MESH_W), np.float64)
        rows[:, MESH_V0:MESH_V0 + 3] = p[:, 0]
        rows[:, MESH_E1:MESH_E1 + 3] = p[:, 1] - p[:, 0]
        rows[:, MESH_E2:MESH_E2 + 3] = p[:, 2] - p[:, 0]
        rows[:, MESH_N0:MESH_N0 + 3] = n[:, 0]
        rows[:, MESH_D1:MESH_D1 + 3] = n[:, 1] - n[:, 0]
        rows[:, MESH_D2:MESH_D2 + 3] = n[:, 2] - n[:, 0]
        rows[:, MESH_MAT] = mat
        k = bvh.num_nodes
        leaf = np.asarray(bvh.is_leaf, bool)
        count = bvh.right.astype(np.int64)
        if leaf.any() and count[leaf].min() < 1:
            raise ValueError("BVH leaf without triangles")
        nodes = np.zeros((k, NODE_W), np.float64)
        nodes[:, NODE_LO:NODE_LO + 3] = bvh.aabb_min
        nodes[:, NODE_HI:NODE_HI + 3] = bvh.aabb_max
        nodes[:, NODE_A] = np.where(leaf, bvh.left + self.n_rows,
                                    bvh.left + self.n_nodes)
        nodes[:, NODE_B] = np.where(leaf, -count, bvh.right + self.n_nodes)
        depth = _bvh._tree_depth(bvh.left, bvh.right, leaf)
        root = self.n_nodes
        self.nodes.append(nodes)
        self.rows.append(rows)
        self.n_nodes += k
        self.n_rows += m
        self.depth = max(self.depth, depth)
        self.max_leaf = max(self.max_leaf, int(count[leaf].max()))
        return root


def _blas_tris(buffers_np, blas_id: int):
    """Object-space float64 points, normals and uv of one BLAS, with the
    geometric-normal fallback for all-zero vertex normals
    (`_pack_inst_mesh` :1011-1021)."""
    starts = buffers_np["blas_idx_start"]
    i0 = int(starts[blas_id])
    i1 = (int(starts[blas_id + 1]) if blas_id + 1 < len(starts)
          else buffers_np["blas_idx"].shape[0])
    v0 = int(buffers_np["blas_vtx_start"][blas_id])
    idx = buffers_np["blas_idx"][i0:i1].reshape(-1, 3).astype(np.int64) + v0
    p = buffers_np["blas_vtx"][idx].astype(np.float64)
    n = buffers_np["blas_nrm"][idx].astype(np.float64)
    zero_n = np.abs(n).sum(axis=(1, 2)) == 0.0
    if zero_n.any():
        gn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        n = np.where(zero_n[:, None, None],
                     np.broadcast_to(gn[:, None, :], n.shape), n)
    return p, n, buffers_np["blas_uv"][idx].astype(np.float64)


def _sphere_table(buffers_np, tbl_idx: np.ndarray, inst_slot: np.ndarray):
    """(sph_tab, sph_box): `_pack_sphere_table`'s centres, radii and
    material slots in its Morton order, in SPH_BLOCK-slot blocks (padding
    slots have radius -1, which no test passes), and each block's box."""
    if tbl_idx.size == 0:
        return (np.zeros((0, SPHT_W), np.float32),
                np.zeros((0, BOX_W), np.float32))
    cs, rs = [], []
    for s in tbl_idx:
        _, c, r = sphere_uniform(buffers_np["sph_o2w"][s])
        cs.append(c)
        rs.append(r)
    cs, rs = np.asarray(cs), np.asarray(rs)
    mats = inst_slot[buffers_np["sph_inst"][tbl_idx]]
    lo = cs.min(0)
    ext = np.maximum(cs.max(0) - lo, 1e-9)
    q = np.clip(((cs - lo) / ext * 1023.0).astype(np.int64), 0, 1023)
    order = np.argsort(_morton3(q), kind="stable")
    cs, rs, mats = cs[order], rs[order], mats[order]
    n = cs.shape[0]
    nb = (n + SPH_BLOCK - 1) // SPH_BLOCK
    tab = np.zeros((nb * SPH_BLOCK, SPHT_W), np.float32)
    tab[:, SPHT_R] = -1.0
    tab[:n, SPHT_C:SPHT_C + 3] = cs
    tab[:n, SPHT_R] = rs
    tab[:n, SPHT_MAT] = mats
    box = np.zeros((nb, BOX_W), np.float32)
    for b in range(nb):
        s0, s1 = b * SPH_BLOCK, min((b + 1) * SPH_BLOCK, n)
        box[b, BOX_LO:BOX_LO + 3] = (cs[s0:s1] - rs[s0:s1, None]).min(0)
        box[b, BOX_HI:BOX_HI + 3] = (cs[s0:s1] + rs[s0:s1, None]).max(0)
    return tab, box


def _entry(tag: int, payload: int) -> int:
    if not 0 <= payload <= TAG_PAYLOAD:
        raise ValueError(f"walk entry payload {payload} out of range")
    return (tag << TAG_SHIFT) | payload


def _leaf_entry(start: int, count: int) -> int:
    if not 1 <= count < 1 << LEAF_COUNT_BITS:
        raise ValueError(f"a BVH leaf of {count} triangles")
    return _entry(TAG_LEAF, (start << LEAF_COUNT_BITS) | count)


class _Wide:
    """Wide rows under construction: per row its children's (k, 6)
    float32 boxes (lo xyz, hi xyz) and walk entries."""

    def __init__(self):
        self.boxes: List[np.ndarray] = []
        self.ents: List[List[int]] = []

    def reserve(self) -> int:
        self.boxes.append(None)
        self.ents.append(None)
        return len(self.ents) - 1

    def need(self, inst_root: Dict[int, int]) -> List[int]:
        """The deepest stack a walk from each row may need: at a row whose
        n children are all entered it pushes n - 1 and goes into one; an
        instance pushes its marker, then walks its BLAS."""
        need = [0] * len(self.ents)
        # children come after their row; an instance's BLAS before the
        # top tree, so a second pass sees the BLAS roots' needs
        for w in [*range(len(self.ents) - 1, -1, -1)] * 2:
            ents = self.ents[w]
            below = 0
            for e in ents:
                tag, pay = e >> TAG_SHIFT, e & TAG_PAYLOAD
                if tag == TAG_NODE:
                    below = max(below, need[pay])
                elif tag == TAG_INST:
                    below = max(below, 1 + need[inst_root[pay]])
            need[w] = len(ents) - 1 + below
        return need

    def rows(self) -> np.ndarray:
        out = np.zeros((len(self.ents), NODE4_W), np.float32)
        refs = out.view(np.int32)[:, NODE4_REF:NODE4_REF + BVH_WIDTH]
        refs[:] = TAG_EMPTY
        for w, (box, ents) in enumerate(zip(self.boxes, self.ents)):
            k = len(ents)
            for c, off in enumerate((NODE4_LX, NODE4_LY, NODE4_LZ)):
                out[w, off:off + k] = box[:, c]
            for c, off in enumerate((NODE4_HX, NODE4_HY, NODE4_HZ)):
                out[w, off:off + k] = box[:, 3 + c]
            refs[w, :k] = ents
        return out


def decode_boxes(wnodes: np.ndarray) -> np.ndarray:
    """The (N, BVH_WIDTH, 6) float32 child boxes (lo xyz, hi xyz) of wide
    rows, as the walk reads them."""
    offs = (NODE4_LX, NODE4_LY, NODE4_LZ, NODE4_HX, NODE4_HY, NODE4_HZ)
    return np.stack([wnodes[:, o:o + BVH_WIDTH] for o in offs], 2)


def _collapse(wide: _Wide, nodes: np.ndarray, root: int,
              leaf_entry=None) -> int:
    """Collapse the binary BVH at node `root` of `nodes` (NODE_W rows,
    absolute indices) into wide rows: a row's children are its binary
    node's two, each interior one of the largest surface area replaced
    by its two until there are BVH_WIDTH or only leaves; returns the wide
    root, a row even where the binary root is a leaf. A binary leaf k
    becomes the walk entry leaf_entry(k), by default the leaf of its
    mesh rows."""
    box = nodes[:, [NODE_LO, NODE_LO + 1, NODE_LO + 2, NODE_HI, NODE_HI + 1,
                    NODE_HI + 2]].astype(np.float32)
    ext = (box[:, 3:] - box[:, :3]).astype(np.float64)
    area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
            + ext[:, 2] * ext[:, 0]).tolist()
    a = nodes[:, NODE_A].astype(np.int64).tolist()
    b = nodes[:, NODE_B].astype(np.int64).tolist()
    top = wide.reserve()
    todo = [(root, top)]
    while todo:
        n, w = todo.pop()
        kids = [n] if b[n] < 0 else [a[n], b[n]]
        while len(kids) < BVH_WIDTH:
            inner = [k for k in kids if b[k] >= 0]
            if not inner:
                break
            k = max(inner, key=area.__getitem__)
            i = kids.index(k)
            kids[i:i + 1] = [a[k], b[k]]
        ents = []
        for k in kids:
            if b[k] < 0:
                ents.append(leaf_entry(k) if leaf_entry
                            else _leaf_entry(a[k], -b[k]))
            else:
                kw = wide.reserve()
                todo.append((k, kw))
                ents.append(_entry(TAG_NODE, kw))
        wide.boxes[w] = box[kids]
        wide.ents[w] = ents
    return top


def _instance_box(w2o: np.ndarray, box: np.ndarray) -> np.ndarray:
    """World box (lo xyz, hi xyz) of the object-space box `box` under the
    inverse of the 3x4 affine `w2o`, padded by INST_BOX_PAD of its size
    and place, rounded outward to float32."""
    m = np.eye(4)
    m[:3] = np.asarray(w2o, np.float64).reshape(3, 4)
    o2w = np.linalg.inv(m)[:3]
    corners = np.array([[box[i], box[1 + j], box[2 + k]]
                        for i in (0, 3) for j in (0, 3) for k in (0, 3)],
                       np.float64)
    pts = corners @ o2w[:, :3].T + o2w[:, 3]
    lo, hi = pts.min(0), pts.max(0)
    pad = INST_BOX_PAD * (np.abs(hi - lo).max() + np.abs(pts).max())
    return np.concatenate([
        np.nextafter((lo - pad).astype(np.float32), np.float32(-np.inf)),
        np.nextafter((hi + pad).astype(np.float32), np.float32(np.inf))])


def _item_tree(boxes: np.ndarray) -> np.ndarray:
    """A binary tree (NODE_W rows, root 0) over (N, 6) float32 item boxes
    by the surface-area heuristic: each node split where the summed area
    times items of its two sides is least, over the items' centres in
    order along each axis; a leaf holds one item (NODE_A, NODE_B -1)."""
    rows: List[np.ndarray] = []

    def area(lo, hi):
        e = np.maximum(hi.astype(np.float64) - lo, 0.0)
        return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] \
            + e[..., 2] * e[..., 0]

    def row(lo, hi, a, b):
        r = np.zeros(NODE_W, np.float32)
        r[NODE_LO:NODE_LO + 3], r[NODE_HI:NODE_HI + 3] = lo, hi
        r[NODE_A], r[NODE_B] = a, b
        return r

    todo = [(np.arange(boxes.shape[0]), 0)]
    rows.append(None)
    while todo:
        idx, n = todo.pop()
        lo, hi = boxes[idx, :3].min(0), boxes[idx, 3:].max(0)
        if idx.size == 1:
            rows[n] = row(lo, hi, idx[0], -1)
            continue
        c = boxes[idx, :3].astype(np.float64) + boxes[idx, 3:]
        best = None
        for axis in range(3):
            o = idx[np.argsort(c[:, axis], kind="stable")]
            b = boxes[o]
            left = area(np.minimum.accumulate(b[:, :3]),
                        np.maximum.accumulate(b[:, 3:]))[:-1]
            right = area(np.minimum.accumulate(b[::-1, :3])[::-1],
                         np.maximum.accumulate(b[::-1, 3:])[::-1])[1:]
            k = np.arange(1, idx.size)
            cost = left * k + right * (idx.size - k)
            i = int(np.argmin(cost))
            if best is None or cost[i] < best[0]:
                best = (cost[i], o[:i + 1], o[i + 1:])
        kids = []
        for part in best[1:]:
            kids.append(len(rows))
            rows.append(None)
            todo.append((part, kids[-1]))
        rows[n] = row(lo, hi, *kids)
    return np.stack(rows)


def _top_tree(wide: _Wide, items: List[Tuple[int, np.ndarray]]) -> int:
    """A wide tree over `items`, (walk entry, (6,) float32 box) each: the
    surface-area binary tree over them (`_item_tree`), collapsed as the
    BVHs are, so that a large item (the world mesh among small
    instances) sits near the root; returns its root row."""
    tree = _item_tree(np.stack([b for _, b in items]).astype(np.float32))
    return _collapse(wide, tree, 0,
                     lambda k: items[int(tree[k, NODE_A])][0])


def wide_tables(nodes: np.ndarray, mesh: np.ndarray, world_root: int,
                insts: np.ndarray, sph_box: np.ndarray) -> Dict:
    """The CUDA walk's tables (see the module's doc) from the binary
    `nodes`, the `mesh` rows, the world root, the instance rows (their
    INST_WROOT is filled in here) and the sphere table's block boxes:
    {"wnodes", "mesh_vt", "top", "walk_need"}; `top` is -1 for a scene
    without acceleration tables. The world BVH's wide rows come first,
    its root at row 0, then each BLAS's, then the top tree's."""
    wide = _Wide()
    roots = {}
    if world_root >= 0:
        roots[world_root] = _collapse(wide, nodes, world_root)
    for r in insts[:, INST_ROOT].astype(np.int64).tolist():
        if r not in roots:
            roots[r] = _collapse(wide, nodes, r)
    inst_root = {}
    items = []
    if world_root >= 0:
        items.append((_entry(TAG_NODE, roots[world_root]),
                      nodes[world_root, [0, 1, 2, 4, 5, 6]].astype(
                          np.float32)))
    for i, row in enumerate(insts):
        r = int(row[INST_ROOT])
        row[INST_WROOT] = roots[r]
        inst_root[i] = roots[r]
        items.append((_entry(TAG_INST, i), _instance_box(
            row[INST_W2O:INST_W2O + 12], nodes[r, [0, 1, 2, 4, 5, 6]])))
    for k, bx in enumerate(sph_box):
        items.append((_entry(TAG_BLOCK, k), bx[[0, 1, 2, 4, 5, 6]].astype(
            np.float32)))
    if not items:
        top = -1
    elif len(items) == 1 and world_root >= 0:
        top = items[0][0]
    else:
        top = _entry(TAG_NODE, _top_tree(wide, items))
    need = wide.need(inst_root)
    walk_need = need[top & TAG_PAYLOAD] if top >= 0 else 0
    if walk_need > TRAVERSAL_STACK:
        raise ValueError(f"the wide BVH walk may need {walk_need} stack "
                         f"entries (> {TRAVERSAL_STACK})")
    vt = np.zeros((mesh.shape[0], VT_W), np.float32)
    vt[:, :9] = mesh[:, MESH_V0:MESH_E2 + 3]
    return {"wnodes": wide.rows(), "mesh_vt": vt, "top": int(top),
            "walk_need": int(walk_need)}


def pack_accel(buffers_np, rest_idx: np.ndarray, shared, tbl_idx,
               inst_slot: np.ndarray, needs_uv: bool = False) -> Dict:
    """The acceleration tables of SceneTables: the world mesh over the
    scene triangles `rest_idx`, the shared BLASes `shared` (from
    `shared_split`) and the table spheres `tbl_idx`, each primitive with
    the material slot of its instance (`inst_slot`, pack.material_slots);
    `needs_uv`: with the `mesh_uv` rows."""
    with trace.span("rene.tables.bvh"):
        b = _Builder()
        world_root = -1
        if rest_idx.size:
            p = buffers_np["tri_p"][rest_idx].astype(np.float64)
            n = buffers_np["tri_n"][rest_idx].astype(np.float64)
            mat = inst_slot[buffers_np["tri_inst"][rest_idx]]
            uv = (buffers_np["tri_uv"][rest_idx].astype(np.float64)
                  if needs_uv else None)
            world_root = b.add(p, n, mat, uv)
        insts = []
        for blas_id, inst_ids in shared:
            p, n, uv = _blas_tris(buffers_np, blas_id)
            root = b.add(p, n, np.zeros(p.shape[0]),
                         uv if needs_uv else None)
            for i in inst_ids:
                row = np.zeros(INST_W, np.float32)
                row[INST_W2O:INST_W2O + 12] = \
                    buffers_np["inst_w2o"][i].reshape(-1)
                row[INST_MAT] = inst_slot[i]
                row[INST_ROOT] = root
                insts.append(row[None])
        sph_tab, sph_box = _sphere_table(buffers_np, np.asarray(tbl_idx),
                                         inst_slot)

        def cat(parts, width):
            return np.ascontiguousarray(
                np.concatenate(parts) if parts else np.zeros((0, width)),
                dtype=np.float32)

        nodes, mesh, insts = (cat(b.nodes, NODE_W), cat(b.rows, MESH_W),
                              cat(insts, INST_W))
    with trace.span("rene.tables.wide"):
        wide = wide_tables(nodes, mesh, world_root, insts, sph_box)
    return dict(wide,
                nodes=nodes, mesh=mesh, mesh_uv=cat(b.uvs, MESH_UV_W),
                insts=insts, sph_tab=sph_tab, sph_box=sph_box,
                world_root=world_root, bvh_depth=b.depth,
                max_leaf=b.max_leaf)
