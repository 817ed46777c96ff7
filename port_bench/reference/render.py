"""What a render of a scene gives at a sample of pixels.

The port's chunk loop (rene_tpu_torch/render.py `run_chunks` at commit
ed2dcef) renders an image of `spp` samples per pixel in chunks of at most
100 samples, one launch a chunk, each with a seed drawn from
`np.random.default_rng(image_seed).integers(0, 2**31, dtype=np.int32)`;
a launch runs lane l = pix + slot * npix for every pixel and sample slot
(`pack` slots a pixel on a scene with a world mesh or instances, else 1),
and a lane's sums depend on its id, its chunk's seed and its chunk's
samples alone. So the pixels of a sample are rendered here lane by lane,
all chunks of all images in one call of the plain lanes (`rt`'s
`path_lanes_ref`, which takes a seed and a sample count per lane), summed
over slots and chunks in the loop's order and averaged as its film is.

The films cast against the meshes by testing every triangle whose
cluster box a ray enters instead of walking the BVHs, the world mesh and
all instances at once (`brute_mesh_closest`, `brute_mesh_any` inside
`brute_walk`): the same test, the same closest hit (the least t, then
the lowest part and row), for a fraction of the plain walk's steps. The
plain walk stays for `count_ops`, whose tests the roofline metrics
count.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .rt.integrators import mega_path as M
from .rt.ops import bvh, intersect, texture
from .rt.scene import accel as A
from .rt.scene import build_device_scene, load_scene
from .rt.scene import pack as P

LOG_EVERY = 100         # the chunk loop's largest chunk (render.py :65)
SEED_END = 2 ** 31      # chunk seeds are int32 below this


def load_tables(path: str, device) -> Dict:
    """Parse the pbrt file at `path` and pack its tables on `device`, as
    the plain versions read them."""
    buffers_np, config = build_device_scene(load_scene(path))
    return M.device_tables(P.pack_tables(buffers_np, config), device)


def pack_for(tabs, spp: int) -> int:
    """The sample slots a pixel gets: on the card `auto_pack` on a scene
    with a world mesh or instances (cluster mode), else 1."""
    if not tabs["block_seed"] or tabs["tris"].device.type != "cuda":
        return 1
    return M.auto_pack(tabs["width"] * tabs["height"], spp)


def chunk_plan(spp: int, pack: int,
               image_seed: int) -> List[Tuple[int, int]]:
    """(chunk seed, samples per lane) of each launch of an image."""
    rng = np.random.default_rng(image_seed)
    plan, done = [], 0
    while done < spp:
        chunk = min(LOG_EVERY, -(-(spp - done) // pack))
        plan.append((int(rng.integers(0, SEED_END, dtype=np.int32)), chunk))
        done += chunk * pack
    return plan


def film_pixels(tabs, spp: int, images: Sequence[Tuple[int, np.ndarray]],
                film_dtypes=(torch.float32,)):
    """The film at pixels `pix` (ray order, px + py * width) of each image
    (image_seed, pix) of `spp` samples per pixel: {"color", "normal",
    "albedo"}, each a list of (len(pix), 3) float32 arrays, and "rays",
    the nominal rays of the lanes run. With several `film_dtypes` (the
    precision of the per-chunk sums and of their accumulation: float32
    is the program's, a lower one the control's), a list of such results,
    one each, from the same lanes."""
    pack = pack_for(tabs, spp)
    npix = tabs["width"] * tabs["height"]
    dev = tabs["tris"].device
    lanes, seeds, nums, shape = [], [], [], []
    for image_seed, pix in images:
        plan = chunk_plan(spp, pack, image_seed)
        pix = torch.as_tensor(np.asarray(pix, np.int64), device=dev)
        for seed, n in plan:
            for slot in range(pack):
                lanes.append(pix + slot * npix)
                seeds.append(torch.full_like(pix, seed))
                nums.append(torch.full_like(pix, n))
        shape.append((len(plan), pix.numel()))
    with brute_walk():
        out = M.path_lanes_ref(tabs, torch.cat(seeds), torch.cat(nums),
                               lanes=torch.cat(lanes), pack=pack)
    rays = float(out[9].double().sum())
    res = [_films(out, shape, pack, spp, dt, rays) for dt in film_dtypes]
    return res if len(res) > 1 else res[0]


def _films(out, shape, pack, spp, film_dtype, rays) -> Dict:
    sums, col = [], 0
    for n_chunks, n_pix in shape:
        block = out[0:9, col:col + n_chunks * pack * n_pix]
        col += block.shape[1]
        # the launch's slots summed per pixel (finish)
        sums.append(block.reshape(9, n_chunks, pack, n_pix).to(film_dtype)
                    .sum(2).permute(1, 0, 2))
    return _accumulate(sums, spp, film_dtype, rays)


def _accumulate(sums, spp, film_dtype, rays) -> Dict:
    """Each image's (chunks, 9, pixels) sums added to a zero film in the
    chunk loop's order, in `film_dtype`, and averaged."""
    res = {"color": [], "normal": [], "albedo": [], "rays": rays}
    for s in sums:
        acc = torch.zeros(s.shape[1:], dtype=film_dtype, device=s.device)
        for c in range(s.shape[0]):
            acc = acc + s[c]
        host = acc.float().cpu().numpy().T / spp
        for key, lo in (("color", 0), ("normal", 3), ("albedo", 6)):
            res[key].append(np.ascontiguousarray(host[:, lo:lo + 3]))
    return res


# -- casts against the meshes by every triangle ------------------------------

CLUSTER = 128       # mesh rows a cluster box holds
PAIR_ROWS = 1 << 23  # (ray, row) tests a block of cluster pairs holds

_CLUSTERS: Dict[Tuple[int, int], Tuple] = {}


def _clusters(tabs, root: int):
    """The mesh rows of the leaves under BVH node `root`, ascending, in
    clusters of CLUSTER ((K, CLUSTER), -1 past the end), and each
    cluster's box of its triangles' vertices, padded outward, as (K, 8)
    rows (min at 0..2, max at 4..6) for `bvh.box_enter`."""
    key = (id(tabs["nodes"]), root)
    if key not in _CLUSTERS:
        nodes = tabs["nodes"].cpu().numpy()
        rows, todo = [], [root]
        while todo:
            n = todo.pop()
            a, b = int(nodes[n, A.NODE_A]), int(nodes[n, A.NODE_B])
            if b < 0:
                rows.append(np.arange(a, a - b))
            else:
                todo += [a, b]
        rows = np.sort(np.concatenate(rows))
        k = -(-rows.size // CLUSTER)
        pad = np.full(k * CLUSTER, -1, np.int64)
        pad[:rows.size] = rows
        mesh = tabs["mesh"].cpu().double().numpy()
        r = mesh[np.maximum(pad, 0)]
        v0 = r[:, A.MESH_V0:A.MESH_V0 + 3]
        pts = np.stack([v0, v0 + r[:, A.MESH_E1:A.MESH_E1 + 3],
                        v0 + r[:, A.MESH_E2:A.MESH_E2 + 3]], 1)
        pts = np.where((pad >= 0)[:, None, None], pts, np.nan)
        pts = pts.reshape(k, CLUSTER * 3, 3)
        lo, hi = np.nanmin(pts, 1), np.nanmax(pts, 1)
        slack = 1e-4 * (hi - lo).max(1, keepdims=True) + 1e-5 \
            + 1e-6 * np.abs(np.concatenate([lo, hi], 1)).max(
                1, keepdims=True)
        box = np.zeros((k, 8))
        box[:, 0:3], box[:, 4:7] = lo - slack, hi + slack
        dev = tabs["nodes"].device
        _CLUSTERS[key] = (
            torch.as_tensor(pad.reshape(k, CLUSTER), device=dev),
            torch.as_tensor(box, dtype=torch.float32, device=dev))
    return _CLUSTERS[key]


def _hits(tabs, root: int, rays, tmin, bound, tmax=None):
    """Every triangle under BVH node `root` whose cluster box (`_clusters`:
    padded outward, so that no triangle a ray meets is passed over) the
    ray enters, tested with the walk's `bvh.mt_test`, for the rays `rays`
    (six (R,) tensors) up to t `bound` ((R,)). With `tmax` (a number):
    the (R,) mask of any hit in [tmin, tmax]. Else each ray's least (t,
    row) hit in [tmin, bound] (ties in t to the lowest row): (ray, t,
    row, u, v) of the rays that have one."""
    rows, box = _clusters(tabs, root)
    ox, oy, oz, dx, dy, dz = rays
    ix, iy, iz = bvh.inv_dir(dx, dy, dz)
    c = [x[:, None] for x in (ox, oy, oz, ix, iy, iz)]
    _, enter = bvh.box_enter(box[None], *c, tmin, bound[:, None])
    pr, pk = enter.nonzero(as_tuple=True)
    n_r = ox.numel()
    hit = torch.zeros(n_r, dtype=torch.long, device=ox.device)
    found = []
    step = max(1, PAIR_ROWS // CLUSTER)
    for a in range(0, pr.numel(), step):
        br, prim = pr[a:a + step], rows[pk[a:a + step]]
        t, u, v, ok = bvh.mt_test(tabs["mesh"][prim.clamp_min(0)],
                                  *(x[br][:, None] for x in rays))
        ok = ok & (prim >= 0) & (t >= tmin)
        if tmax is not None:
            hit.index_add_(0, br, (ok & (t <= tmax)).any(1).long())
            continue
        tb, jb = torch.where(ok, t, math.inf).min(1)
        w = ok.any(1)
        jb = jb[:, None]
        found.append((br[w], tb[w], prim.gather(1, jb)[:, 0][w],
                      u.gather(1, jb)[:, 0][w], v.gather(1, jb)[:, 0][w]))
    if tmax is not None:
        return hit > 0
    if not found:
        e = torch.zeros(0, device=ox.device)
        return (e.long(), e, e.long(), e, e)
    return tuple(torch.cat(x) for x in zip(*found))


def _least(n: int, keys, vals):
    """Per index in [0, n), the entry of `keys` = (index, k1, k2, k3)
    least in (k1, k2, k3): (has one (n,), k1, k2, k3, *vals) per index."""
    idx, k1, k2, k3 = keys
    dev = k1.device
    m1 = torch.full((n,), math.inf, device=dev).scatter_reduce(
        0, idx, k1, "amin")
    at = k1 == m1[idx]
    big = torch.full((n,), 1 << 62, dtype=torch.long, device=dev)
    m2 = big.clone().scatter_reduce(0, idx[at], k2[at], "amin")
    at &= k2 == m2[idx]
    m3 = big.clone().scatter_reduce(0, idx[at], k3[at], "amin")
    at &= k3 == m3[idx]
    out = [torch.zeros(n, dtype=v.dtype, device=dev).index_put_(
        (idx[at],), v[at]) for v in vals]
    return (torch.isfinite(m1), m1, m2, m3, *out)


def _groups(tabs):
    """The meshes a cast tests: (BVH root, [(part, instance row or None)])
    for the world mesh and for each BLAS its instances share."""
    out = []
    if tabs["world_root"] >= 0:
        out.append((tabs["world_root"], [(bvh.PART_WORLD, None)]))
    by_root: Dict[int, list] = {}
    for i, row in enumerate(tabs["insts_f"]):
        by_root.setdefault(int(row[A.INST_ROOT]), []).append(
            (bvh.PART_INST + i, row))
    return out + sorted(by_root.items())


def _group_rays(ray, members):
    """The rays of every member of a group (world or object space), one
    block of the lanes' rays per member, and each ray's part."""
    blocks = [ray if row is None else bvh._to_object(row, *ray)
              for _, row in members]
    rays = [torch.cat([b[c] for b in blocks]) for c in range(6)]
    n = ray[0].numel()
    part = torch.cat([torch.full((n,), p, dtype=torch.long,
                                 device=ray[0].device) for p, _ in members])
    return rays, part


def brute_mesh_closest(tabs, ox, oy, oz, dx, dy, dz, tmin, t, done=None,
                       ids=None):
    """`rt.ops.bvh.mesh_closest` by `_hits` over the world mesh and every
    instance at once: the hit with the least t, then the lowest part,
    then the lowest row, below the immediates' `t` (which keeps an equal
    t), as the walk fixes it; the same outputs."""
    n = ox.numel()
    dev = ox.device
    best_t = t.clone()
    best = {"prim": torch.full((n,), -1, dtype=torch.long, device=dev),
            "part": torch.full((n,), bvh.PART_IMM, dtype=torch.long,
                               device=dev),
            "u": torch.zeros_like(ox), "v": torch.zeros_like(ox)}
    lane = (torch.arange(n, device=dev) if done is None
            else (~done).nonzero()[:, 0])
    if lane.numel():
        ray = [x[lane] for x in (ox, oy, oz, dx, dy, dz)]
        for root, members in _groups(tabs):
            rays, part = _group_rays(ray, members)
            m = len(members)
            bound = best_t[lane].repeat(m)
            r, tt, prim, u, v = _hits(tabs, root, rays, tmin, bound)
            li = r % lane.numel()
            has, t_c, p_c, r_c, u_c, v_c = _least(
                lane.numel(), (li, tt, part[r], prim), (u, v))
            w = has & (t_c < best_t[lane])
            best_t[lane] = torch.where(w, t_c, best_t[lane])
            for key, val in (("prim", r_c), ("part", p_c), ("u", u_c),
                             ("v", v_c)):
                best[key][lane] = torch.where(w, val, best[key][lane])
    inst = torch.where(best["part"] >= bvh.PART_INST,
                       best["part"] - bvh.PART_INST, -1)
    if ids is not None:
        on = best["prim"] >= 0
        ids["part"] = torch.where(on, best["part"], -1)
        ids["row"] = best["prim"]
    r = tabs["mesh"][best["prim"].clamp_min(0)]
    u, v = best["u"], best["v"]
    nrm = [r[:, A.MESH_N0 + c] + u * r[:, A.MESH_D1 + c]
           + v * r[:, A.MESH_D2 + c] for c in range(3)]
    mat = r[:, A.MESH_MAT]
    if tabs["insts_f"]:
        mi = tabs["insts"][inst.clamp_min(0)]
        on = inst >= 0
        w = [mi[:, c] * nrm[0] + mi[:, 4 + c] * nrm[1] + mi[:, 8 + c] * nrm[2]
             for c in range(3)]
        nrm = [torch.where(on, w[c], nrm[c]) for c in range(3)]
        mat = torch.where(on, mi[:, A.INST_MAT], mat)
    tu = tv = torch.zeros_like(u)
    if tabs["mesh_uv"].shape[0]:
        q = tabs["mesh_uv"][best["prim"].clamp_min(0)]
        tu = q[:, 0] + u * q[:, 2] + v * q[:, 4]
        tv = q[:, 1] + u * q[:, 3] + v * q[:, 5]
    return best_t, nrm[0], nrm[1], nrm[2], mat.long(), tu, tv


def brute_mesh_any(tabs, ox, oy, oz, dx, dy, dz, tmin, tmax, done):
    """`rt.ops.bvh.mesh_any` by `_hits`: any mesh hit in [tmin, tmax] for
    the lanes not `done`."""
    hit = torch.zeros_like(done)
    lane = (~done).nonzero()[:, 0]
    if not lane.numel():
        return hit
    ray = [x[lane] for x in (ox, oy, oz, dx, dy, dz)]
    for root, members in _groups(tabs):
        rays, _ = _group_rays(ray, members)
        bound = torch.full_like(rays[0], float(tmax))
        h = _hits(tabs, root, rays, tmin, bound, tmax)
        hit[lane] |= h.view(len(members), -1).any(0)
    return hit


@contextlib.contextmanager
def brute_walk():
    """Cast against the meshes with `brute_mesh_closest` and
    `brute_mesh_any` inside the block."""
    saved = bvh.mesh_closest, bvh.mesh_any
    bvh.mesh_closest, bvh.mesh_any = brute_mesh_closest, brute_mesh_any
    try:
        yield
    finally:
        bvh.mesh_closest, bvh.mesh_any = saved


# -- the plain walk's counts, for the roofline metrics ------------------------

def count_ops(tabs, spp: int, seed: int, n_lanes: int) -> Dict:
    """The plain versions' work per sample on `n_lanes` of the
    megakernel's lanes over the film at the image's pack, drawn from
    `seed`, one sample each: the nominal rays, the BVH box, triangle and
    table-sphere tests, the texels and, in a volpath scene, the casts by
    kind, the FP32 operations of those casts (`ops`, bounds.cast_ops);
    the bytes of the tables a launch reads once, the texture atlas
    apart."""
    from . import bounds as B
    dev = tabs["tris"].device
    gen = np.random.default_rng(seed)
    reset_counts()
    pack = pack_for(tabs, spp)
    n_all = tabs["width"] * tabs["height"] * pack
    lanes = torch.as_tensor(gen.choice(n_all, min(n_lanes, n_all),
                                       replace=False), device=dev)
    out = M.path_lanes_ref(tabs, torch.full_like(lanes, seed & 0x7FFFFFFF),
                           1, lanes=lanes, pack=pack)
    samples = float(lanes.numel())
    per = {k: v / samples for k, v in plain_counts().items()}
    per["pack"] = pack
    per["rays"] = float(out[9].double().sum()) / samples
    per["ops"] = B.cast_ops(tabs, per["rays"], per)
    atlas = tabs["atlas"].numel() * tabs["atlas"].element_size()
    per["table_bytes"] = float(B.table_bytes(tabs) - atlas)
    per["atlas_bytes"] = float(atlas)
    per["texel_bytes"] = 4.0 * per.get("texels", 0.0)
    return per


def reset_counts():
    for k in bvh.tests:
        bvh.tests[k] = 0
    for k in intersect.casts:
        intersect.casts[k] = 0
    texture.counts["texels"] = 0


def plain_counts() -> Dict:
    out = dict(bvh.tests, texels=texture.counts["texels"])
    if any(intersect.casts.values()):
        out.update(intersect.casts)
    return out
