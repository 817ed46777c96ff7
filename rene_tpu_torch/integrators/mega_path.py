"""The path megakernel on the port's main path (slices K1a-K1d, K1f).

Counterpart of rene_tpu/integrators/pallas_path.py `make_pallas_batch_fn`
(:5819-6061): the TPU kernel `_build_kernel` -> `kernel` (:4266) running
its path `body` (:4346-4570) over every lane, then `finish` (:5974)
mapping lanes to pixels. Scenes past the immediates budget add the mesh
BVHs, shared-BLAS instances and the sphere table (ops/bvh.py) to every
ray cast and fold distant lights from a table; in the JAX kernel's
cluster mode (a world mesh or instances) a lane's stream is seeded per
pixel block, the tile that mode gives it.

Sample-in-tile packing (K1f, cluster mode only): `pack` in (1, 4, 16,
64, 256) sample slots per pixel, each a lane of its own, so one call of
`num_samples` per-lane samples delivers num_samples * pack per pixel.
Lane l is pixel l % npix at slot l // npix (slot-major; the JAX kernel
keeps the slots of a pixel inside its tile), its tile the (32 //
sqrt(pack))-pixel block of the pixel, its stream seeded by the lane id
pix + slot * npix and its Sobol key mixed with the slot (:4307-4337);
`finish` sums the slots.
Textured material slots are evaluated at the hit's uv, a textured
background at the miss direction's spherical uv, and an env-map
background joins the emitters as a light-sampling strategy (K1b,
ops/texture.py).

Each lane owns one pixel slot and streams `num_samples` paths back to back,
regenerating a camera ray when a path ends: camera ray, closest hit,
emitter hit, distant-light NEE, BSDF sampling, the 50/50 emitter/BSDF
MIS, Russian roulette from depth 12. Per iteration a lane draws, in this
order: u_coin, u1, u2, ul; coin, ue1..ue4 when the scene has emitters or
an env-map strategy, then upick when it has both; rrv when Russian
roulette is on; cj1, cj2 always.

Under `Sampler "sobol"` (tables' `sobol`) the same draws come in pairs
from ops/sobol.py's Owen-scrambled (0,2)-sequence instead
(pallas_path.py:4328-4341, :4437-4542), keyed by the pixel and the lane's
grid-step seed (ops/sobol.py `pixkey`), indexed by the lane's sample
number and its depth, one slot per pair: (u1, u2) SLOT_BSDF, (u_coin, ul)
SLOT_COIN, (ue1, ue2) SLOT_NEE1, (ue3, ue4) SLOT_NEE2, (coin, upick)
SLOT_MISC, rrv SLOT_RR, and the camera's (cj1, cj2) SLOT_CAM at depth 0
with the sample index after the finished path is counted. The path body
then draws nothing from the lane stream.

`path_lanes_ref` is the plain PyTorch version of the CUDA kernel in
csrc/mega_path.cu: the same body over masked lane tensors, in the same
draw order. `make_mega_batch_fn` returns the runner the render loop
calls: on a CUDA device it launches the kernel, on the CPU it runs the
plain version.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .. import kernels, trace
from ..ops import rng
from ..ops import sobol as SB
from ..ops.bsdf import bsdf_eval, bsdf_sample, gather_material, is_diffuse
from ..ops.intersect import TMIN, closest, emit_pdf
from ..ops.texture import (apply_textures, background, env_pdf_dir,
                           env_strategy)
from ..ops.vec3 import dot3, normalize3, onb_from_w, to_local, to_world
from ..scene import pack as P
from ..scene.device import to_torch
from .camera import camera_ray
from .common import distant_lights, sample_emit

FLT_MIN_NORMAL = 1.17549435e-38   # the least normal float32


def device_tables(tables: P.SceneTables, device) -> Dict:
    """The scene tables on `device` (the upload inside span
    `rene.tables.upload`), plus the python constants the plain version
    folds into its arithmetic."""
    arrays = tables.arrays()
    # torch's CPU uint32 has no indexing or shifts: the RGB9E5 words
    # travel as int32 bit patterns
    arrays["atlas"] = arrays["atlas"].view(np.int32)
    with trace.span("rene.tables.upload"):
        tabs = to_torch(arrays, device)
    tabs["cam_f"] = [float(x) for x in tables.cam]
    tabs["lights_f"] = [tuple(float(x) for x in row)
                        for row in tables.lights]
    tabs["has_tri_emitter"] = bool(
        (tables.emit_objects[:, P.EO_KIND] == 0).any())
    tabs["width"], tabs["height"] = tables.width, tables.height
    tabs["max_depth"] = tables.max_depth
    tabs["use_rr"] = tables.use_rr
    tabs["volpath"] = tables.volpath
    tabs["n_emit"] = int(tables.emit_objects.shape[0])
    tabs["insts_f"] = tables.insts.tolist()
    for k in ("world_root", "bvh_depth", "max_leaf", "top", "has_accel",
              "block_seed", "has_tex", "bg_kind", "has_env", "sobol"):
        tabs[k] = getattr(tables, k)
    return tabs


def bounce(tabs, c, active, beckmann: bool = False) -> Dict:
    """One bounce of the path body for the lanes where `active`: closest
    hit, background on a miss, the one-sided emitter hit, the AOVs at
    depth 0, distant-light NEE, BSDF sampling with the 50/50 emitter MIS,
    Russian roulette and the depth cut; then the two camera draws of a
    regenerated path. `c` holds the ray (ox..dz), throughput (cr, cg,
    cb), `depth`, the radiance and AOV sums (rr.., anx.., aar..) and the
    lane streams `st`, and under Sobol `sob` (`sobol_draws`). Returns the
    updated sums, `alive` (the path goes on), the hit point (hx, hy, hz),
    the next direction (wx, wy, wz), the next throughput (cr, cg, cb), the
    advanced streams `st` and the camera draws cj1, cj2 (None under
    Sobol: the caller draws them with the sample index after the path is
    counted). Lanes outside `active` still draw. A throughput below
    float32's normal range counts as zero and ends the path, as under
    the flush-to-zero arithmetic of XLA and the TPU."""
    cr, cg, cb = c["cr"], c["cg"], c["cb"]
    depth = c["depth"]

    t, hit, anx_, any__, anz_, alr, alg, alb, mat_id, tu, tv = closest(
        tabs, c["ox"], c["oy"], c["oz"], c["dx"], c["dy"], c["dz"], TMIN,
        skip=~active)
    attr = gather_material(tabs["mats"], mat_id, hit)
    if tabs["has_tex"]:
        attr = apply_textures(tabs, attr, mat_id, active & hit, tu, tv)
    miss = active & ~hit
    bg = background(tabs, c["dx"], c["dy"], c["dz"], miss)
    rr_ = c["rr"] + torch.where(miss, cr * bg[0], 0.0)
    rg_ = c["rg"] + torch.where(miss, cg * bg[1], 0.0)
    rb_ = c["rb"] + torch.where(miss, cb * bg[2], 0.0)
    alive = active & hit

    hx = c["ox"] + t * c["dx"]
    hy = c["oy"] + t * c["dy"]
    hz = c["oz"] + t * c["dz"]
    nx, ny, nz = normalize3(anx_, any__, anz_)
    wox, woy, woz = -c["dx"], -c["dy"], -c["dz"]
    ux, uy, uz, vx, vy, vz = onb_from_w(nx, ny, nz)

    # emitter hit (one-sided)
    al_on = alive & ((alr != 0.0) | (alg != 0.0) | (alb != 0.0)) \
        & (dot3(wox, woy, woz, nx, ny, nz) > 0.0)
    rr_ = rr_ + torch.where(al_on, cr * alr, 0.0)
    rg_ = rg_ + torch.where(al_on, cg * alg, 0.0)
    rb_ = rb_ + torch.where(al_on, cb * alb, 0.0)

    # AOVs at depth 0
    first = alive & (depth == 0)
    anx = c["anx"] + torch.where(first, nx, 0.0)
    any_ = c["any"] + torch.where(first, ny, 0.0)
    anz = c["anz"] + torch.where(first, nz, 0.0)
    aar = c["aar"] + torch.where(first, attr["abr"], 0.0)
    aag = c["aag"] + torch.where(first, attr["abg"], 0.0)
    aab = c["aab"] + torch.where(first, attr["abb"], 0.0)

    frame = (ux, uy, uz, vx, vy, vz, nx, ny, nz)
    lo = to_local(*frame, wox, woy, woz)
    rr_, rg_, rb_ = distant_lights(
        tabs, tabs["lights_f"], (rr_, rg_, rb_), hx, hy, hz, frame,
        attr, lo, alive, cr, cg, cb, beckmann)

    sob = c.get("sob")
    wx_, wy_, wz_, f_r, f_g, f_b, pdf, _, st = scatter(
        tabs, attr, frame, lo, hx, hy, hz, c["st"], beckmann, sob)

    alive = alive & (pdf >= 1e-5)
    cosw = torch.abs(wx_ * nx + wy_ * ny + wz_ * nz)
    scale = cosw / torch.clamp_min(pdf, 1e-20)
    cr = cr * f_r * scale
    cg = cg * f_g * scale
    cb = cb * f_b * scale
    alive = alive & (torch.maximum(cr, torch.maximum(cg, cb))
                     >= FLT_MIN_NORMAL)

    if tabs["use_rr"]:
        if sob is not None:
            rrv, _ = SB.ld2(*sob, SB.SLOT_RR)
        else:
            rrv, st = rng.uniform(st)
        p_cont = torch.clamp(torch.maximum(cr, torch.maximum(cg, cb)),
                             0.0, 1.0)
        do_rr = depth > P.RR_START
        alive = alive & (~do_rr | (rrv <= p_cont))
        inv_p = 1.0 / torch.clamp_min(p_cont, 1e-20)
        keep = do_rr & alive
        cr = torch.where(keep, cr * inv_p, cr)
        cg = torch.where(keep, cg * inv_p, cg)
        cb = torch.where(keep, cb * inv_p, cb)

    alive = alive & (depth + 1 < tabs["max_depth"])
    cj1, cj2, st = camera_draws(st, sob)
    return {"rr": rr_, "rg": rg_, "rb": rb_, "anx": anx, "any": any_,
            "anz": anz, "aar": aar, "aag": aag, "aab": aab,
            "alive": alive, "hx": hx, "hy": hy, "hz": hz,
            "wx": wx_, "wy": wy_, "wz": wz_, "cr": cr, "cg": cg, "cb": cb,
            "st": st, "cj1": cj1, "cj2": cj2}


def camera_draws(st, sob):
    """The stream's two camera draws of a regenerated path, the last of
    a bounce; none under Sobol (`sob` given), whose camera pair the
    caller draws once the path's sample is counted."""
    if sob is not None:
        return None, None, st
    cj1, st = rng.uniform(st)
    cj2, st = rng.uniform(st)
    return cj1, cj2, st


def sobol_draws(idx, pixkey, depth):
    """`sob`: the (sample index, pixel key, depth) triple every Sobol pair
    of a bounce is drawn from (ops/sobol.py ld2), as int64."""
    return (idx.to(torch.int64), pixkey, depth.to(torch.int64))


def scatter(tabs, attr, frame, lo, hx, hy, hz, st, beckmann: bool = False,
            sob=None):
    """The path body's next direction at a surface: BSDF sampling, and on
    diffuse surfaces of a scene with emitters or an env-map strategy the
    one-sample 50/50 MIS between the BSDF and one light sampler per lane
    (an emit object or the env map, picked by an independent draw when
    the scene has both). Draws u_coin, u1, u2, ul, then coin, ue1..ue4
    (and upick) where the scene has such lights: from the stream `st`,
    or under Sobol from the pairs of `sob` (`sobol_draws`). Returns (wx,
    wy, wz, f_r, f_g, f_b, pdf, diffuse, advanced streams)."""
    E = tabs["n_emit"]
    has_env = tabs["has_env"]
    if sob is not None:
        u1, u2 = SB.ld2(*sob, SB.SLOT_BSDF)
        u_coin, ul = SB.ld2(*sob, SB.SLOT_COIN)
    else:
        u_coin, st = rng.uniform(st)
        u1, st = rng.uniform(st)
        u2, st = rng.uniform(st)
        ul, st = rng.uniform(st)
    swx, swy, swz, sfr, sfg, sfb, spdf = bsdf_sample(
        attr, *lo, u_coin, u1, u2, ul, beckmann)
    swx, swy, swz = to_world(*frame, swx, swy, swz)
    diffuse = is_diffuse(attr)
    if not (E > 0 or has_env):
        return swx, swy, swz, sfr, sfg, sfb, spdf, diffuse, st
    if sob is not None:
        ue1, ue2 = SB.ld2(*sob, SB.SLOT_NEE1)
        ue3, ue4 = SB.ld2(*sob, SB.SLOT_NEE2)
        coin, upick = SB.ld2(*sob, SB.SLOT_MISC)
    else:
        coin, st = rng.uniform(st)
        ue1, st = rng.uniform(st)
        ue2, st = rng.uniform(st)
        ue3, st = rng.uniform(st)
        ue4, st = rng.uniform(st)
    if E > 0:
        ls_wx, ls_wy, ls_wz = sample_emit(tabs, hx, hy, hz,
                                          ue1, ue2, ue3, ue4)
    if has_env:
        ex_, ey_, ez_ = env_strategy(tabs, ue1, ue2, ue3, ue4)
        if E > 0:
            if sob is None:
                upick, st = rng.uniform(st)
            tke = upick * float(E + 1) < 1.0
            ls_wx = torch.where(tke, ex_, ls_wx)
            ls_wy = torch.where(tke, ey_, ls_wy)
            ls_wz = torch.where(tke, ez_, ls_wz)
        else:
            ls_wx, ls_wy, ls_wz = ex_, ey_, ez_
    take_light = (coin > 0.5) & diffuse
    wx_ = torch.where(take_light, ls_wx, swx)
    wy_ = torch.where(take_light, ls_wy, swy)
    wz_ = torch.where(take_light, ls_wz, swz)
    llx, lly, llz = to_local(*frame, ls_wx, ls_wy, ls_wz)
    fe_r, fe_g, fe_b, fe_pdf = bsdf_eval(attr, *lo, llx, lly, llz, beckmann)
    f_r = torch.where(take_light, fe_r, sfr)
    f_g = torch.where(take_light, fe_g, sfg)
    f_b = torch.where(take_light, fe_b, sfb)
    pdf_b = torch.where(take_light, fe_pdf, spdf)
    lp_ = emit_pdf(tabs, hx, hy, hz, wx_, wy_, wz_) if E > 0 \
        else torch.zeros_like(hx)
    if has_env:
        lp_ = lp_ + env_pdf_dir(tabs, wx_, wy_, wz_)
    lpdf = lp_ / torch.full_like(hx, float(E + (1 if has_env else 0)))
    pdf = torch.where(diffuse, 0.5 * pdf_b + 0.5 * lpdf, spdf)
    return (torch.where(diffuse, wx_, swx), torch.where(diffuse, wy_, swy),
            torch.where(diffuse, wz_, swz), torch.where(diffuse, f_r, sfr),
            torch.where(diffuse, f_g, sfg), torch.where(diffuse, f_b, sfb),
            pdf, diffuse, st)


def ray_increment(tabs) -> float:
    """Rays a bounce casts: the closest hit, one shadow ray per distant
    light and the emitter-pdf ray of the MIS when the scene has
    emitters."""
    return 1.0 + len(tabs["lights_f"]) + (1.0 if tabs["n_emit"] > 0
                                          else 0.0)


def lane_start(tabs, lanes: torch.Tensor, seed: int, pack=1):
    """Where lane ids `lanes` start (csrc/mega_lane.cuh `lane_start`):
    (pixel, grid step, xorshift32 state, Sobol pixel key) as int64. Lane
    l is sample slot l // npix of pixel l % npix; its grid step the
    pixel's 8192-lane step, or in cluster mode its block of edge
    `rng.block_edge(pack)` (`pack` an int, or each lane's); its stream
    seeded by the lane id, its Sobol key by the pixel and the step's seed
    mixed with the slot."""
    npix = tabs["width"] * tabs["height"]
    lanes = lanes.to(torch.int64)
    pix, slot = lanes % npix, lanes // npix
    tile = rng.tile_of(pix, tabs["width"], tabs["block_seed"],
                       rng.block_edge(pack))
    seed_u = (int(seed) + tile * 65537) & rng.MASK
    return (pix, tile, rng.seed_state(lanes, seed, tile),
            SB.pixkey(pix, seed_u, slot))


def path_lanes_ref(tabs, seed: int, num_samples: int,
                   beckmann: bool = False, lanes=None,
                   pack=1) -> torch.Tensor:
    """Plain PyTorch path megakernel: (10, N) float32 per-lane sums of
    radiance rgb, first-hit normal xyz, albedo rgb and the ray count over
    the npix * pack lanes of the film, lane l sample slot l // npix of
    pixel l % npix (`lane_start`), or over the lane ids `lanes` (an int64
    tensor; a lane's result depends on its own id only). `pack` > 1 only
    for cluster-mode tables (`block_seed`); with `lanes`, it may be an
    int64 tensor of each lane's pack, so that the lanes of launches at
    several packs walk at once. Volpath tables run the
    volpath bounce (integrators/volpath.py), each lane carrying its
    medium. Under Sobol each lane's key is ops/sobol.py `pixkey` of its
    pixel, its grid-step seed (the stream's `seed + tile * 65537`) and
    its slot."""
    from .volpath import bounce_vol
    vol = tabs["volpath"]
    step = bounce_vol if vol else bounce
    W = tabs["width"]
    cam = tabs["cam_f"]
    for p in (pack.unique().tolist() if torch.is_tensor(pack) else [pack]):
        kernels.lane_count(tabs, p)
    if lanes is None:
        lanes = torch.arange(W * tabs["height"] * pack,
                             device=tabs["tris"].device)
    pix, _, st, pixkey = lane_start(tabs, lanes, seed, pack)
    pxf = (pix % W).float()
    pyf = (pix // W).float()
    izero = torch.zeros_like(pix)
    if tabs["sobol"]:
        ju0, jv0 = SB.ld2(izero, pixkey, izero, SB.SLOT_CAM)
    else:
        ju0, st = rng.uniform(st)
        jv0, st = rng.uniform(st)
    dx, dy, dz = camera_ray(cam, pxf, pyf, ju0, jv0)
    zero = torch.zeros_like(pxf)
    co = cam[P.CAM_ORIGIN:P.CAM_ORIGIN + 3]
    ray_inc = ray_increment(tabs)
    c = {"ox": zero + co[0], "oy": zero + co[1], "oz": zero + co[2],
         "dx": dx, "dy": dy, "dz": dz,
         "cr": zero + 1.0, "cg": zero + 1.0, "cb": zero + 1.0,
         "depth": izero, "sample": izero,
         "rr": zero, "rg": zero, "rb": zero,
         "anx": zero, "any": zero, "anz": zero,
         "aar": zero, "aag": zero, "aab": zero, "rays": zero, "st": st}
    if vol:
        c["med"] = zero

    while bool((c["sample"] < num_samples).any()):
        active = c["sample"] < num_samples
        rays = c["rays"] + torch.where(active, 1.0, 0.0) * ray_inc
        if tabs["sobol"]:
            c["sob"] = sobol_draws(c["sample"], pixkey, c["depth"])
        b = step(tabs, c, active, beckmann)
        alive = b["alive"]

        # regeneration
        finished = active & ~alive
        sample = c["sample"] + finished.long()
        regen = finished & (sample < num_samples)
        cj1, cj2 = (SB.ld2(sample, pixkey, izero, SB.SLOT_CAM)
                    if tabs["sobol"] else (b["cj1"], b["cj2"]))
        cdx, cdy, cdz = camera_ray(cam, pxf, pyf, cj1, cj2)

        def pick3(a1, a2, b2c):
            return torch.where(regen, a1, torch.where(alive, a2, b2c))

        med = pick3(zero, b["med"], c["med"]) if vol else None
        c = {"ox": pick3(zero + co[0], b["hx"], c["ox"]),
             "oy": pick3(zero + co[1], b["hy"], c["oy"]),
             "oz": pick3(zero + co[2], b["hz"], c["oz"]),
             "dx": pick3(cdx, b["wx"], c["dx"]),
             "dy": pick3(cdy, b["wy"], c["dy"]),
             "dz": pick3(cdz, b["wz"], c["dz"]),
             "cr": pick3(zero + 1.0, b["cr"], c["cr"]),
             "cg": pick3(zero + 1.0, b["cg"], c["cg"]),
             "cb": pick3(zero + 1.0, b["cb"], c["cb"]),
             "depth": torch.where(regen, 0, torch.where(
                 alive, c["depth"] + 1, c["depth"])),
             "sample": sample, "rays": rays, "st": b["st"],
             **{k: b[k] for k in ("rr", "rg", "rb", "anx", "any", "anz",
                                  "aar", "aag", "aab")}}
        if vol:
            c["med"] = med

    return torch.stack([c[k] for k in ("rr", "rg", "rb", "anx", "any", "anz",
                                       "aar", "aag", "aab", "rays")])


def finish(out: torch.Tensor, pack: int = 1) -> Dict[str, torch.Tensor]:
    """(10, npix * pack) lane sums -> per-pixel dict: each pixel's sums
    over its `pack` sample slots (lane l is pixel l % npix), the film
    accumulation the JAX runner's `finish` does outside its kernel
    (:5976-5980)."""
    if pack != 1:
        out = out.view(P.OUT_ROWS, pack, -1).sum(1)
    return {"radiance": out[0:3].T, "normal": out[3:6].T,
            "albedo": out[6:9].T,
            "rays": out[9].sum(dtype=torch.float64)}


# a set of threads as the pack sweep counted them: four 128-thread blocks
# on each of the H100's 132 SMs, the mesh builds' floor when it ran
# (csrc/mega_path.cu PATH_MIN_BLOCKS has since been raised; the rule below
# is the sweep's reading, in these units)
RESIDENT_LANES = 132 * 4 * 128
# `auto` packs a cluster-mode film until its lanes fill this many
# resident sets of threads. The pack sweep on an H100 (PERF.md section 6,
# `python -m rene_tpu_torch.probe --pack-sweep`), Mrays/s against pack 1:
# a 160x90 film (0.21 sets) 2.49x at pack 4, 4.14x at 16; 320x180 (0.85
# sets) 1.16-1.30x at 4 (3.4 sets), 1.24-1.52x at 16 (13.6 sets); 1280x720
# (13.6 sets) 0.95-1.01x at 4, 0.97-1.09x at 16
AUTO_FILL = 8


def auto_pack(npix: int, spp: int) -> int:
    """The pack `auto` gives a cluster-mode film of `npix` pixels rendered
    at `spp` samples per pixel on the card: among the packs that divide
    `spp` (a call delivers pack samples per pixel, so the render runs
    exactly `spp`), the smallest that brings its lanes to AUTO_FILL x
    RESIDENT_LANES, else the largest. The JAX runner's `auto_pack`
    (:5791) sized the pack against the TPU's runtime watchdog, which the
    card does not have."""
    best = 1
    for p in rng.PACKS:
        if p > max(spp, 1):
            break
        if spp % p:
            continue
        best = p
        if npix * p >= AUTO_FILL * RESIDENT_LANES:
            break
    return best


def choose_pack(tabs, pack: int, device, spp: int) -> int:
    """The runner's pack: `pack`, or for 0 the environment's
    RENE_MEGA_PACK (read once per runner, as the JAX runner does), whose
    "auto" or absence means `auto_pack` on the card and 1 on the CPU (the
    JAX runner's interpret mode). Checked by kernels.lane_count (a pack
    in rng.PACKS, fewer than 2^31 lanes; ValueError); 1 on scenes outside
    cluster mode (:5895-5896)."""
    npix = tabs["width"] * tabs["height"]
    if pack == 0:
        env = os.environ.get("RENE_MEGA_PACK", "")
        if env and env != "auto":
            pack = int(env)
        else:
            pack = auto_pack(npix, spp) if torch.device(device).type \
                == "cuda" and tabs["block_seed"] else 1
    if not tabs["block_seed"]:
        rng.block_edge(pack)    # a pack outside rng.PACKS raises all the same
        return 1
    kernels.lane_count(tabs, pack)
    return pack


def make_mega_batch_fn(buffers_np, config, device, pack: int = 0,
                       spp_hint: int = 0, pixels=None):
    """Runner for the chunk loop: `run(seed, num_samples)` returns per-pixel
    (N, 3) radiance/normal/albedo SUMS over the chunk's num_samples *
    run.spp_mult samples and the ray count. Raises NotImplementedError for
    scenes the port does not carry (`pack.slice_supported`).

    `pack` (`choose_pack`; 0: RENE_MEGA_PACK, else `auto` for a render of
    `spp_hint` samples per pixel): sample slots per pixel on a cluster-mode
    scene, run.spp_mult = pack.

    `pixels` = (lo, hi), a tiles-mode rank's share of the film
    (parallel/shard.py): every call launches those pixels' lanes alone
    (`kernels.mega_path(..., pixels=)`) and returns their hi - lo rows;
    `run.pixels` tells the chunk loop where they go.

    On a CUDA device every call launches csrc/mega_path.cu once (counted
    in `kernels.launches` under its variant: mega_volpath[_mesh] for
    `Integrator "volpath"`); on the CPU it runs `path_lanes_ref`, or
    volpath.vol_lanes_ref. There is no fallback between the two. Chunks stay
    at 100 samples: the JAX runner's smaller `chunk_hint` for mesh scenes
    (:6020-6032) keeps a TPU call under its watchdog and is not carried
    over."""
    device = torch.device(device)
    tabs = device_tables(P.pack_tables(buffers_np, config), device)
    pack = choose_pack(tabs, pack, device, spp_hint)
    # the RENE_MF_DIST=beckmann diagnostic (pallas_path.py:3563), read once
    # per runner as the JAX kernel reads it once per build
    beckmann = os.environ.get("RENE_MF_DIST", "") == "beckmann"

    lo, hi = pixels or (0, tabs["width"] * tabs["height"])

    def run(seed: int, num_samples: int):
        return finish(kernels.mega_path(tabs, int(seed), int(num_samples),
                                        beckmann, pack, (lo, hi - lo)),
                      pack)

    run.chunk_hint = 100
    run.spp_mult = pack
    run.pixels = (lo, hi)
    return run
