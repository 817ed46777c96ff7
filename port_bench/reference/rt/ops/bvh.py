"""Frozen copy of rene_tpu_torch/ops/bvh.py at commit ed2dcef; BVH.intersect,
the XLA engine's walk, left out.

Ray casts against the mesh BVHs and the sphere table (K1c, K1d).

Plain PyTorch version of csrc/bvh.cuh. Counterparts in
rene_tpu/integrators/pallas_path.py: `mesh_closest` (:2255) and
`mesh_any` (:2440) over the world mesh and every shared-BLAS instance
(`trace_closest` :2973-3072, `trace_any` :3177-3209), and
`sphere_closest` (:2636) / `sphere_any` (:2663) over the sphere table;
their per-triangle test `_mt_test` (:2148-2164), box gate
`_box_enter_row` (:2172) with `_inv_dir` (:2057), and sphere test
`_sph_test` (:2620), each with the same operations in the same order.

The CUDA kernel walks the same trees in another form (scene/accel.py
`wide_tables`: 4-wide nodes, one walk over the world mesh, the instances
and the sphere table, in whatever order the boxes give). Here all lanes
walk the binary tree in lock-step, as rene_tpu/ops/bvh.py:62-175 does:
each step gathers the live lanes by index, tests all of a leaf's
triangles or both children's boxes at once, pushes the far child when
both are entered, and pops when a lane is done with a subtree; lanes
that finish drop out. The bound (rene_tpu_torch/bounds.py) counts this
walk's tests. So that both find the same hit whatever their order, the
closest hit is fixed by (t, part, row): the least t; on an exact tie the
lowest part (the immediates, the world mesh, the instances by row, the
table spheres); within a part the lowest mesh row or table slot. A step
writes its lanes' updates through `torch.where` rather than boolean
masks, so that on a card it waits on the device only where it must
count lanes.

The builder below (`build_bvh` and its median-split fallback) is
rene_tpu/ops/bvh.py's host-side build: binned SAH through the native C++
builder (ops/native.py), median splits where that is missing or too
deep. `BVH.to_device` and `BVH.intersect` are that file's traversal, the
XLA engine's walk: every lane carries a stack of MAX_DEPTH_STACK nodes,
internal nodes test both child boxes and descend into the nearer one
(the left on a tie in t_near), pushing the other, leaves test LEAF_SIZE
slots; the loop runs while any lane is live. It keeps its own visiting
order and its strict-less update of the closest hit (the first triangle
found at the least t wins), unlike `march` above.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..scene import accel as A

BIG = 3e38
# the parts of a mesh scene, in the order that breaks an exact tie in t:
# the immediates, the world mesh, then instance i as PART_INST + i and the
# sphere table after the last instance (csrc/intersect.cuh)
PART_IMM, PART_WORLD, PART_INST = 0, 1, 2
# box, triangle and table-sphere tests of the walk's lanes so far (reset
# by the caller): chip_smoke.py reads them for the kernels' operation
# bounds
tests = {"box": 0, "tri": 0, "sph": 0}

# -- host-side build (rene_tpu/ops/bvh.py) ----------------------------------
LEAF_SIZE = 4
MAX_DEPTH_STACK = 40  # SAH depth over <=1M tris is ~2*log2(N/4)


class BVH:
    def __init__(self, aabb_min, aabb_max, left, right, is_leaf, order,
                 tri_p_sorted):
        self.aabb_min = aabb_min
        self.aabb_max = aabb_max
        self.left = left
        self.right = right
        self.is_leaf = is_leaf
        self.order = order
        self.tri_p_sorted = tri_p_sorted

    @property
    def num_nodes(self):
        return self.left.shape[0]

    def to_device(self, device):
        """The tree's arrays as tensors on `device`."""
        self.device = torch.device(device)
        self._device = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in (("aabb_min", self.aabb_min),
                         ("aabb_max", self.aabb_max),
                         ("left", self.left.astype(np.int64)),
                         ("right", self.right.astype(np.int64)),
                         ("is_leaf", self.is_leaf),
                         ("order", self.order.astype(np.int64)),
                         ("tri_p", self.tri_p_sorted))}
        return self


def _tree_depth(left, right, is_leaf) -> int:
    """Max root-to-leaf depth (root = depth 0), iterative BFS."""
    depth = 0
    frontier = [0] if left.shape[0] else []
    d = 0
    while frontier:
        depth = d
        nxt = []
        for node in frontier:
            if not is_leaf[node]:
                nxt.append(int(left[node]))
                nxt.append(int(right[node]))
        frontier = nxt
        d += 1
    return depth


def build_bvh(tri_p: np.ndarray, use_native: bool = True) -> BVH:
    """BVH build over (T,3,3) world-space triangles.

    Prefers the native C++ binned-SAH builder (native/bvh_builder.cpp via
    ctypes); falls back to the numpy median-split builder below. A native
    tree deeper than the traversal stack (possible for pathological SAH
    splits) would silently drop far children in `intersect`, so such trees
    are rebuilt with median splits (depth <= ceil(log2(N/LEAF_SIZE)) + 1,
    always well under MAX_DEPTH_STACK).
    """
    tri_p = np.asarray(tri_p, np.float32)
    if use_native and tri_p.shape[0] > 0:
        from .native import native_build_bvh
        out = native_build_bvh(tri_p, LEAF_SIZE)
        if out is not None:
            aabb_min, aabb_max, left, right, is_leaf, order = out
            # reserve one slot: traversal pushes at most depth-1 far children
            if _tree_depth(left, right, is_leaf) < MAX_DEPTH_STACK:
                return _finish(tri_p, aabb_min, aabb_max, left, right,
                               is_leaf, order.astype(np.int64))
            import logging
            logging.getLogger("rene_tpu_torch.bvh").warning(
                "native SAH tree exceeds the %d-entry traversal stack; "
                "rebuilding with median splits", MAX_DEPTH_STACK)
    return _build_median(tri_p)


def _finish(tri_p, aabb_min, aabb_max, left, right, is_leaf, order):
    ntri = tri_p.shape[0]
    pad = (-ntri) % LEAF_SIZE  # allow fixed-width leaf loop to over-read
    order32 = order.astype(np.int32)
    tri_sorted = tri_p[order]
    if pad:
        tri_sorted = np.concatenate(
            [tri_sorted, np.zeros((pad, 3, 3), np.float32)], axis=0)
        order32 = np.concatenate([order32, np.zeros(pad, np.int32)], axis=0)
    return BVH(aabb_min, aabb_max, left.astype(np.int32),
               right.astype(np.int32), np.asarray(is_leaf, bool), order32,
               tri_sorted)


def _build_median(tri_p: np.ndarray) -> BVH:
    """Numpy median-split fallback builder."""
    ntri = tri_p.shape[0]
    lo = tri_p.min(axis=1)  # (T,3)
    hi = tri_p.max(axis=1)
    centroid = 0.5 * (lo + hi)

    order = np.arange(ntri, dtype=np.int64)

    max_nodes = max(2 * ntri - 1, 1)
    aabb_min = np.zeros((max_nodes, 3), np.float32)
    aabb_max = np.zeros((max_nodes, 3), np.float32)
    left = np.zeros(max_nodes, np.int32)
    right = np.zeros(max_nodes, np.int32)
    is_leaf = np.zeros(max_nodes, bool)
    n_nodes = 1

    # iterative build: (node_id, start, end)
    stack = [(0, 0, ntri)]
    while stack:
        node, s, e = stack.pop()
        ids = order[s:e]
        aabb_min[node] = lo[ids].min(axis=0)
        aabb_max[node] = hi[ids].max(axis=0)
        count = e - s
        if count <= LEAF_SIZE:
            is_leaf[node] = True
            left[node] = s
            right[node] = count
            continue
        c = centroid[ids]
        ext = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            mid = count // 2  # degenerate: split in half by current order
        else:
            mid = count // 2
            part = np.argpartition(c[:, axis], mid)
            order[s:e] = ids[part]
        lnode, rnode = n_nodes, n_nodes + 1
        n_nodes += 2
        left[node] = lnode
        right[node] = rnode
        stack.append((lnode, s, s + mid))
        stack.append((rnode, s + mid, e))

    return _finish(tri_p, aabb_min[:n_nodes], aabb_max[:n_nodes],
                   left[:n_nodes], right[:n_nodes], is_leaf[:n_nodes], order)


# -- lock-step walk -----------------------------------------------------------


def sqrt_rn(x):
    """The square root rounded once, as sqrtf on the card and in C: torch's
    vectorized float32 sqrt on the CPU may miss by an ulp (a float64 root
    rounded to float32 is the float32 root rounded once)."""
    return torch.sqrt(x.double()).float()


def inv_dir(dx, dy, dz):
    """1 / d with |d| held above 1e-20, sign kept (`_inv_dir` :2057)."""
    def inv(d):
        return 1.0 / torch.where(d.abs() > 1e-20, d,
                                 torch.where(d >= 0, 1e-20, -1e-20))
    return inv(dx), inv(dy), inv(dz)


def box_enter(box, ox, oy, oz, ix, iy, iz, tmin, tfar):
    """Slab test of (..., 8) boxes (min at 0..2, max at 4..6): (t near,
    whether the ray enters within [tmin, tfar])."""
    t0x = (box[..., 0] - ox) * ix
    t1x = (box[..., 4] - ox) * ix
    t0y = (box[..., 1] - oy) * iy
    t1y = (box[..., 5] - oy) * iy
    t0z = (box[..., 2] - oz) * iz
    t1z = (box[..., 6] - oz) * iz
    tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                     torch.minimum(t0y, t1y)),
                       torch.minimum(t0z, t1z))
    tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                     torch.maximum(t0y, t1y)),
                       torch.maximum(t0z, t1z))
    return tn, tn.clamp_min(tmin) <= torch.minimum(tf, tfar)


def mt_test(r, ox, oy, oz, dx, dy, dz):
    """Möller-Trumbore of rays against (..., MESH_W) triangle rows: (t, u,
    v, ok); the caller applies its t bounds."""
    v0x, v0y, v0z = (r[..., A.MESH_V0 + c] for c in range(3))
    e1x, e1y, e1z = (r[..., A.MESH_E1 + c] for c in range(3))
    e2x, e2y, e2z = (r[..., A.MESH_E2 + c] for c in range(3))
    px_ = dy * e2z - dz * e2y
    py_ = dz * e2x - dx * e2z
    pz_ = dx * e2y - dy * e2x
    det = e1x * px_ + e1y * py_ + e1z * pz_
    invd = 1.0 / torch.where(det.abs() > 1e-12, det, 1e-12)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px_ + ty * py_ + tz * pz_) * invd
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * invd
    t = (e2x * qx + e2y * qy + e2z * qz) * invd
    ok = (det.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def march(tabs, root, ray, tmin, tmax, best, done, part=PART_WORLD):
    """Walk the BVH at node `root` for every lane not `done`, for rays
    `ray` = (ox, oy, oz, dx, dy, dz). Closest hit when `best` is a dict
    of (N,) t, prim, u, v and optionally part (updated in place: t is the
    running bound, prim the mesh row of the closest triangle, (u, v) its
    barycentrics, part its part): a triangle of this walk's `part` takes
    the lane's hit at a lesser t, or at an equal t from a higher row of
    the same part (of any part where `best` has none); any hit in [tmin,
    tmax] otherwise, returned as an (N,) mask."""
    nodes, mesh = tabs["nodes"], tabs["mesh"]
    ox, oy, oz, dx, dy, dz = ray
    # the rays and their inverse directions, one row per lane
    rays = torch.stack((ox, oy, oz, dx, dy, dz) + inv_dir(dx, dy, dz), 1)
    hit = torch.zeros_like(ox, dtype=torch.bool)

    def tfar(ln):
        return best["t"][ln] if best is not None \
            else torch.full_like(ox[ln], tmax)

    def at(ln):
        return rays[ln].unbind(1)

    lane = (~done).nonzero()[:, 0]
    tests["box"] += lane.numel()
    r0 = nodes[root].expand(lane.numel(), -1)
    _, enter = box_enter(r0, *at(lane)[0:3], *at(lane)[6:9], tmin,
                         tfar(lane))
    lane = lane[enter]
    k = lane.numel()
    dev = ox.device
    node = torch.full((k,), root, dtype=torch.int64, device=dev)
    stack = torch.zeros((k, tabs["bvh_depth"] + 1), dtype=torch.int64,
                        device=dev)
    sp = torch.zeros(k, dtype=torch.int64, device=dev)
    alive = torch.ones(k, dtype=torch.bool, device=dev)
    while k:
        rows = nodes[node]
        is_leaf = rows[:, A.NODE_B] < 0
        pop = alive & is_leaf

        li = pop.nonzero()[:, 0]
        if li.numel():
            # a leaf's triangles j < count, all at once: the closest is
            # the first of the least t below the lane's bound, as the
            # kernel's loop over them keeps it
            start = rows[li, A.NODE_A].long()
            count = (-rows[li, A.NODE_B]).long()
            n_leaf, n_tri = torch.stack((count.max(), count.sum())).tolist()
            tests["tri"] += n_tri
            j = torch.arange(n_leaf, device=dev)
            m = count[:, None] > j
            prim = torch.where(m, start[:, None] + j, start[:, None])
            ln = lane[li]
            t, u, v, ok = mt_test(mesh[prim],
                                  *(x[:, None] for x in at(ln)[0:6]))
            ok = m & ok & (t >= tmin)
            if best is None:
                h = (ok & (t <= tmax)).any(1)
                hit[ln] |= h
                alive[li] &= ~h
            else:
                # the least t, then the lowest row: a leaf's rows rise
                # with j, and min keeps the first of equal values
                bt = best["t"][ln][:, None]
                tie = (t == bt) & (prim < best["prim"][ln][:, None])
                if "part" in best:
                    tie &= best["part"][ln][:, None] == part
                ok &= (t < bt) | tie
                tb, jb = torch.where(ok, t, math.inf).min(1)
                w = ok.any(1)
                jb = jb[:, None]
                new = [("t", tb), ("prim", prim.gather(1, jb)[:, 0]),
                       ("u", u.gather(1, jb)[:, 0]),
                       ("v", v.gather(1, jb)[:, 0])]
                if "part" in best:
                    new.append(("part", torch.full_like(tb, part,
                                                        dtype=torch.long)))
                for key, val in new:
                    best[key][ln] = torch.where(w, val, best[key][ln])

        ii = (alive & ~is_leaf).nonzero()[:, 0]
        if ii.numel():
            # both children's boxes at once; enter the nearer, push the
            # other when both are entered, pop when neither is
            ln = lane[ii]
            tests["box"] += 2 * ln.numel()
            o = at(ln)
            kids = rows[ii][:, (A.NODE_A, A.NODE_B)].long()
            tn, hk = box_enter(nodes[kids], *(x[:, None] for x in o[0:3]),
                               *(x[:, None] for x in o[6:9]), tmin,
                               tfar(ln)[:, None])
            lc, rc = kids.unbind(1)
            hl, hr = hk.unbind(1)
            both = hl & hr
            lfirst = tn[:, 0] <= tn[:, 1]
            nxt = torch.where(both, torch.where(lfirst, lc, rc),
                              torch.where(hl, lc, rc))
            far = torch.where(lfirst, rc, lc)
            top = sp[ii]
            stack[ii, top] = torch.where(both, far, stack[ii, top])
            sp[ii] = top + both
            go = hl | hr
            node[ii] = torch.where(go, nxt, node[ii])
            pop[ii] |= ~go

        pi = (pop & alive).nonzero()[:, 0]
        can = sp[pi] > 0
        top = sp[pi] - can.long()
        sp[pi] = top
        node[pi] = torch.where(can, stack[pi, top], node[pi])
        alive[pi] &= can

        n_alive = int(alive.sum())
        if n_alive < k // 2 or n_alive == 0:
            keep = alive.nonzero()[:, 0]
            lane, node, stack = lane[keep], node[keep], stack[keep]
            sp, alive = sp[keep], alive[keep]
            k = n_alive
    return hit


def _to_object(row, ox, oy, oz, dx, dy, dz):
    """A ray in an instance's object space (its 3x4 w2o; d is not
    renormalized, so t stays the world t)."""
    m = row[A.INST_W2O:A.INST_W2O + 12]
    return (m[0] * ox + m[1] * oy + m[2] * oz + m[3],
            m[4] * ox + m[5] * oy + m[6] * oz + m[7],
            m[8] * ox + m[9] * oy + m[10] * oz + m[11],
            m[0] * dx + m[1] * dy + m[2] * dz,
            m[4] * dx + m[5] * dy + m[6] * dz,
            m[8] * dx + m[9] * dy + m[10] * dz)


def mesh_closest(tabs, ox, oy, oz, dx, dy, dz, tmin, t, done=None,
                 ids=None):
    """Closest mesh hit below `t` for the lanes not `done` (all when
    None): the world mesh, then each instance, the hit fixed by (t,
    part, row) (the module's doc); `t` is the immediates' (their part
    wins an equal t). Where `ids` is a dict it receives the (N,) part
    and mesh row of the hit, -1 where no mesh triangle is closer.
    Returns (t, nx, ny, nz, material id, u, v), t unchanged where no
    mesh triangle is closer; the normal is the interpolated shading
    normal n0 + b1 d1 + b2 d2 (not normalized), taken to world space as
    W2O^T n for an instance hit; (u, v) = uv0 + b1 duv1 + b2 duv2 from
    the `mesh_uv` rows of a textured mesh, else zero."""
    ray = (ox, oy, oz, dx, dy, dz)
    best = {"t": t.clone(), "prim": torch.full_like(ox, -1, dtype=torch.long),
            "u": torch.zeros_like(ox), "v": torch.zeros_like(ox),
            "part": torch.full_like(ox, PART_IMM, dtype=torch.long)}
    if done is None:
        done = torch.zeros_like(ox, dtype=torch.bool)
    if tabs["world_root"] >= 0:
        march(tabs, tabs["world_root"], ray, tmin, None, best, done,
              PART_WORLD)
    for i, row in enumerate(tabs["insts_f"]):
        march(tabs, int(row[A.INST_ROOT]), _to_object(row, *ray), tmin,
              None, best, done, PART_INST + i)
    inst = torch.where(best["part"] >= PART_INST, best["part"] - PART_INST,
                       -1)
    if ids is not None:
        on = best["prim"] >= 0
        ids["part"] = torch.where(on, best["part"], -1)
        ids["row"] = best["prim"]

    r = tabs["mesh"][best["prim"].clamp_min(0)]
    u, v = best["u"], best["v"]
    n = [r[:, A.MESH_N0 + c] + u * r[:, A.MESH_D1 + c]
         + v * r[:, A.MESH_D2 + c] for c in range(3)]
    mat = r[:, A.MESH_MAT]
    if tabs["insts_f"]:
        m = tabs["insts"][inst.clamp_min(0)]
        on = inst >= 0
        w = [m[:, c] * n[0] + m[:, 4 + c] * n[1] + m[:, 8 + c] * n[2]
             for c in range(3)]
        n = [torch.where(on, w[c], n[c]) for c in range(3)]
        mat = torch.where(on, m[:, A.INST_MAT], mat)
    tu = tv = torch.zeros_like(u)
    if tabs["mesh_uv"].shape[0]:
        q = tabs["mesh_uv"][best["prim"].clamp_min(0)]
        tu = q[:, 0] + u * q[:, 2] + v * q[:, 4]
        tv = q[:, 1] + u * q[:, 3] + v * q[:, 5]
    return best["t"], n[0], n[1], n[2], mat.long(), tu, tv


def mesh_any(tabs, ox, oy, oz, dx, dy, dz, tmin, tmax, done):
    """Any mesh hit in [tmin, tmax] for the lanes not `done`."""
    ray = (ox, oy, oz, dx, dy, dz)
    hit = torch.zeros_like(done)
    if tabs["world_root"] >= 0:
        hit |= march(tabs, tabs["world_root"], ray, tmin, tmax, None,
                      done | hit)
    for row in tabs["insts_f"]:
        hit |= march(tabs, int(row[A.INST_ROOT]), _to_object(row, *ray),
                      tmin, tmax, None, done | hit)
    return hit


def _sph_test(rows, ox, oy, oz, dx, dy, dz, tmin):
    """(t, ok) of lanes (K, 1) against table spheres (1, B): the centre/
    radius test `_sph_test` (:2620); t is BIG where no root >= tmin."""
    cx, cy, cz = rows[:, A.SPHT_C], rows[:, A.SPHT_C + 1], \
        rows[:, A.SPHT_C + 2]
    rr = rows[:, A.SPHT_R]
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    hb = ocx * dx + ocy * dy + ocz * dz
    c2 = ocx * ocx + ocy * ocy + ocz * ocz - rr * rr
    disc = hb * hb - c2
    sq = sqrt_rn(disc.clamp_min(0.0))
    r0 = -hb - sq
    r1 = -hb + sq
    t = torch.where(r0 >= tmin, r0, torch.where(r1 >= tmin, r1, BIG))
    return t, (disc >= 0.0) & (rr > 0.0)


def sphere_table_closest(tabs, ox, oy, oz, dx, dy, dz, tmin, t, done=None,
                         ids=None):
    """Closest table sphere below `t` for the lanes not `done` (all when
    None), block by block behind each block's box: (t, nx, ny, nz,
    material id, 0, 0); the normal is (hit - c) / r, and a table sphere's
    material is solid, so it has no (u, v). The blocks in slot order and
    strict less between them keep the lowest slot of an equal t. Where
    `ids` is a dict it receives the (N,) slot, -1 where none is closer."""
    tab, box = tabs["sph_tab"], tabs["sph_box"]
    ray = (ox, oy, oz, dx, dy, dz)
    ix, iy, iz = inv_dir(dx, dy, dz)
    t = t.clone()
    best = torch.full_like(ox, -1, dtype=torch.long)
    todo = torch.ones_like(ox, dtype=torch.bool) if done is None else ~done
    n_todo = int(todo.sum())
    for b in range(box.shape[0]):
        _, enter = box_enter(box[b:b + 1], ox, oy, oz, ix, iy, iz, tmin, t)
        tests["box"] += n_todo
        ln = (enter & todo).nonzero()[:, 0]
        if not ln.numel():
            continue
        tests["sph"] += ln.numel() * A.SPH_BLOCK
        rows = tab[b * A.SPH_BLOCK:(b + 1) * A.SPH_BLOCK]
        ts, ok = _sph_test(rows, *(x[ln, None] for x in ray), tmin)
        tb, kb = torch.where(ok, ts, math.inf).min(dim=1)
        w = tb < t[ln]
        idx = ln[w]
        t[idx] = tb[w]
        best[idx] = b * A.SPH_BLOCK + kb[w]
    if ids is not None:
        ids["row"] = best
    r = tab[best.clamp_min(0)]
    rr = r[:, A.SPHT_R]
    invr = 1.0 / torch.where(rr > 0.0, rr, 1.0)
    n = [(ray[c] + t * ray[3 + c] - r[:, A.SPHT_C + c]) * invr
         for c in range(3)]
    zero = torch.zeros_like(t)
    return t, n[0], n[1], n[2], r[:, A.SPHT_MAT].long(), zero, zero


def sphere_table_any(tabs, ox, oy, oz, dx, dy, dz, tmin, tmax, done):
    """Any table sphere hit in [tmin, tmax] for the lanes not `done`."""
    tab, box = tabs["sph_tab"], tabs["sph_box"]
    ray = (ox, oy, oz, dx, dy, dz)
    ix, iy, iz = inv_dir(dx, dy, dz)
    hit = torch.zeros_like(done)
    far = torch.full_like(ox, tmax)
    for b in range(box.shape[0]):
        _, enter = box_enter(box[b:b + 1], ox, oy, oz, ix, iy, iz, tmin, far)
        todo = ~done & ~hit
        ln = (enter & todo).nonzero()[:, 0]
        tests["box"] += int(todo.sum())
        if not ln.numel():
            continue
        tests["sph"] += ln.numel() * A.SPH_BLOCK
        rows = tab[b * A.SPH_BLOCK:(b + 1) * A.SPH_BLOCK]
        ts, ok = _sph_test(rows, *(x[ln, None] for x in ray), tmin)
        hit[ln] = (ok & (ts <= tmax)).any(dim=1)
    return hit
