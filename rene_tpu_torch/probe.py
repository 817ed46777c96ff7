"""Where a main-path render's time goes, on a CUDA card.

    python -m rene_tpu_torch.probe [--scene cornell|big_mesh|textured_mesh|
                                            fog_mesh] [--out DIR]
    python -m rene_tpu_torch.probe --scene fog_mesh --scatter-share
    python -m rene_tpu_torch.probe --pack-sweep
    python -m rene_tpu_torch.probe --compare DIR [DIR ...] [--only LABEL ...]
    python -m rene_tpu_torch.probe --main-launches

Renders one of the main paths' inline scenes: the Cornell box
(rene_tpu_torch.scenes.cornell_box, K1a variant, at 1024x1024), the big
mesh (scenes.big_mesh_scene, mesh variant, at 1280x720), the textured
mesh (scenes.textured_mesh_scene, the mesh variant with textures, an
env-map background and env-map light sampling, at 1280x720; its scene
and image files go to build/probe_scenes/) or the fog mesh
(scenes.fog_mesh_scene, the volpath mesh variant, maxdepth 64, at
1280x720), and prints one JSON object per line:

* the card (nvidia-smi name, power limit, SM clock and its maximum);
* the creation of the CUDA context, then the host phases of one render:
  scene load, `build_device_scene`, `pack_tables` (with the BVH builds,
  whose binary and wide parts come from their spans `rene.tables.bvh`
  and `rene.tables.wide` under a CPU profiler), the tables' upload;
* renders through `render()` after a warm-up launch (64, 256 and 1024
  spp for the Cornell box; 16, 64 and 256 for the big mesh): rays, wall
  time, Mrays/s, launches;
* the PNG encode of the last image;
* the kernel's time per launch by chunk size (CUDA events over 5 launches
  each) and its Mrays/s;
* for a textured scene, the 4-spp launch once more with one part of
  slice K1b switched off at a time (the per-hit material textures, the
  env-map light sampling, the background's fetch): what each part costs.
  The switched-off launches trace other paths, so their rays are given
  beside their times;
* for the big mesh, the mesh walk (K1c/K1d) alone (`walk_report`): the
  rays of the plain version's casts on a strided sample of ~131k pixels
  at 1 spp and maxdepth 4 (`walk_rays`: camera rays, bounce rays at
  depths 1-3, shadow rays), cast by the ray-cast probe
  (kernels.cast_probe) kind by kind, Mrays/s by CUDA events, and through
  the counting build (kernels.WALK_COUNT) nodes, boxes, leaves,
  triangles, instances and table blocks per cast, the active lanes of a
  warp at the head of the walk loop and the deepest stack; the same
  counts over the 1- and 16-spp launches (`mega_path_walk_counts`) with
  the walks' share of the threads' clock cycles; and the host times of
  the BVH tables (the binary builds, the wide tables);
* for the fog mesh, the counting build's step counts (`step_counts`) at
  1 and 16 spp: the lanes of a warp active at the volpath lane loop's
  cast site, the steps per lane and the share of them that are march
  segments;
* for a volpath scene, a wave of the wave engine at the smallest render
  spp, its device time split into init (K3), step (K2 launches), sort
  and finish; for the fog mesh the same wave through K2's counting build
  (`k2_record`), its counts per launch;
* a render at the smallest of those spp under torch.profiler
  (trace.py `profiled`): wall time and the operations with the most
  device time; the Chrome trace, with the program's spans, goes to DIR.

Needs a CUDA device and nvcc; it builds the kernels on first use.

`--pack-sweep` measures sample-in-tile packing (K1f) instead: the big
mesh at 1280x720, 320x180 and 160x90 and the fog mesh at 1280x720 and
320x180, each at pack 1, 4 and 16 delivering 16 spp, and at pack 1 and
64 delivering 64 spp (`pack_sweep`).

`--compare` times the same launches of kernel libraries built from other
copies of csrc/ (for example the parent commit's, `git show` into a
directory under build/, or copies with another block floor), each
library swapped in for the package's own around its launches, in
rounds that take the directories in turn and back (A, B, B, A): the
ptxas registers and spill stores of each build, then per launch and
directory the median milliseconds, the rays, and the per-pixel agreement
with the first directory's output (rene_tpu_torch.checks); the mesh walk
alone, each kind of `walk_rays` through each build's ray-cast probe,
Mrays/s and its results' agreement with the first directory's; for the
copies whose bvh.cuh has walk counts, the big mesh's 16-spp launch
through their counting build (`walk_counts`); and, for
each copy that has the counting build, its step counts on the fog mesh
(`step_counts`) and its K2 counts per launch of the fog mesh's wave.
The launches (`COMPARE_LAUNCHES`): the volpath megakernel's at 1280x720
(the fog mesh at maxdepth 64 at 1 and 16 spp and at pack 4, the fog
scene at 1 and 16 spp, the Sobol 1-spp launches of both), the first K2
launch of each volpath wave (independent and Sobol), the 1-spp launches
of the megakernel's two path builds and the first K2 launches of the
Cornell box's and the big mesh's waves; then the whole 16-spp waves of
the fog mesh and the fog scene, both samplers (`compare_waves`): their K2
ms, summed and per launch, and the agreement of the finished films.

`--main-launches` times what each kernel costs on its main path
(`MAIN_PATHS`, the paths chip_smoke.py drives through the CLI): the
megakernel's launch at the path's own spp and pack (CUDA events, the
median of three), and for a wave path one wave at its spp with its device
time split into init (K3), K2 launches, sorts (K4 under `dma`) and finish,
with the launches of each kernel; then the same wave with each K2 launch
timed alone (`k2_record`: k, lanes launched, alive at its start and end,
lane-bounces, ms), and for a volpath wave once more with each launch's
bound (rene_tpu_torch.bounds), from the plain version on a sample of its
alive lanes.

`--scatter-share` needs neither: it counts, with the plain volpath
megakernel on the CPU at 1 spp and a 128x72 film of the scene, the share
of camera paths that scatter in a medium at least once.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import torch

from . import kernels, scenes, trace
from .integrators import mega_path as M
from .render import render
from .scene import build_device_scene, load_scene
from .scene import pack as P
from .utils.film import save_png, to_rgb8


# scene -> (pbrt text of (directory, w, h), default film, render spp,
# chunk spp)
SCENES = {
    "cornell": (lambda d, w, h: scenes.cornell_box(w, h), (1024, 1024),
                (64, 256, 1024), (1, 4, 16, 64, 100)),
    "big_mesh": (lambda d, w, h: scenes.big_mesh_scene(w, h), (1280, 720),
                 (16, 64, 256), (1, 4, 16, 64)),
    "textured_mesh": (scenes.textured_mesh_scene, (1280, 720), (16, 64, 256),
                      (1, 4, 16, 64)),
    "fog_mesh": (lambda d, w, h: scenes.fog_mesh_scene(w, h), (1280, 720),
                 (16, 64, 256), (1, 4, 16)),
}
SHARE_FILM = (128, 72)
SCENE_DIR = os.path.join("build", "probe_scenes")
# the pack sweep: films, and per delivered spp the packs that run it
PACK_FILMS = (("big_mesh", 1280, 720), ("big_mesh", 320, 180),
              ("big_mesh", 160, 90), ("fog_mesh", 1280, 720),
              ("fog_mesh", 320, 180))
PACK_RUNS = ((16, (1, 4, 16)), (64, (1, 64)))
PACK_ROUNDS = 3
# --compare: the libraries it builds and its launches, (label, scene, spp,
# pack, sampler) at the scene's main film (`main_scene`); "k2" launches
# are the first K2 launch of the scene's wave at 16 spp
COMPARE_LIBS = ("mega_volpath", "mega_volpath_mesh", "wave_volpath",
                "wave_volpath_mesh", "mega_path", "mega_path_mesh",
                "wave_path", "wave_path_mesh")
COMPARE_LAUNCHES = (
    ("fog_mesh 1 spp", "fog_mesh", 1, 1, "independent"),
    ("fog_mesh 16 spp", "fog_mesh", 16, 1, "independent"),
    ("fog_mesh pack 4", "fog_mesh", 1, 4, "independent"),
    ("fog 1 spp", "fog", 1, 1, "independent"),
    ("fog 16 spp", "fog", 16, 1, "independent"),
    ("fog_mesh sobol 1 spp", "fog_mesh", 1, 1, "sobol"),
    ("fog sobol 1 spp", "fog", 1, 1, "sobol"),
    ("fog_mesh K2 first", "fog_mesh", "k2", 1, "independent"),
    ("fog K2 first", "fog", "k2", 1, "independent"),
    ("fog_mesh sobol K2 first", "fog_mesh", "k2", 1, "sobol"),
    ("fog sobol K2 first", "fog", "k2", 1, "sobol"),
    ("cornell 1 spp", "cornell", 1, 1, "independent"),
    ("big_mesh 1 spp", "big_mesh", 1, 1, "independent"),
    ("big_mesh 16 spp", "big_mesh", 16, 1, "independent"),
    ("big_mesh sobol 16 spp", "big_mesh", 16, 1, "sobol"),
    ("big_mesh pack 16", "big_mesh", 1, 16, "independent"),
    ("textured_mesh 16 spp", "textured_mesh", 16, 1, "independent"),
    ("cornell K2 first", "cornell", "k2", 1, "independent"),
    ("big_mesh K2 first", "big_mesh", "k2", 1, "independent"),
    ("cornell 64 spp", "cornell", 64, 1, "independent"),
    ("cornell sobol 64 spp", "cornell", 64, 1, "sobol"),
    ("textured_mesh 1 spp", "textured_mesh", 1, 1, "independent"),
    ("textured_deep K2 first", "textured_deep", "k2", 1, "independent"))
# the libraries of each scene's megakernel and K2 (kernels.variant)
SCENE_LIBS = {"cornell": ("mega_path", "wave_path"),
              "fog": ("mega_volpath", "wave_volpath"),
              "fog_mesh": ("mega_volpath_mesh", "wave_volpath_mesh")}
SCENE_LIBS.update({k: ("mega_path_mesh", "wave_path_mesh") for k in (
    "big_mesh", "deep_mesh", "textured_mesh", "textured_deep")})
# --main-launches: (label, scene, maxdepth (None: the scene's own),
# sampler, engine ("mega", or the wave's sort mode), spp, pack)
MAIN_PATHS = tuple(
    (f"{label}{' sobol' if smp == 'sobol' else ''}", scene, depth, smp, eng,
     spp, pack)
    for label, scene, depth, eng, spp, pack, smps in (
        ("cornell", "cornell", None, "mega", 64, 1, (0, 1)),
        ("cornell wave", "cornell", None, "gather", 16, 1, (0, 1)),
        ("big mesh", "big_mesh", None, "mega", 16, 1, (0, 1)),
        ("big mesh pack 16", "big_mesh", None, "mega", 16, 16, (0, 1)),
        ("big mesh wave", "big_mesh", None, "gather", 16, 1, (1,)),
        ("deep mesh wave", "big_mesh", 50, "gather", 16, 1, (0,)),
        ("deep mesh dma wave", "big_mesh", 50, "dma", 16, 1, (0,)),
        ("textured mesh", "textured_mesh", None, "mega", 16, 1, (0,)),
        ("textured deep mesh wave", "textured_mesh", 50, "gather", 16, 1,
         (0,)),
        ("fog mesh", "fog_mesh", None, "mega", 16, 1, (0, 1)),
        ("fog mesh pack 4", "fog_mesh", None, "mega", 16, 4, (0, 1)),
        ("fog mesh wave", "fog_mesh", None, "gather", 16, 1, (0, 1)),
        ("fog", "fog", None, "mega", 16, 1, (0, 1)),
        ("fog wave", "fog", None, "gather", 16, 1, (0, 1)))
    for smp in (("independent", "sobol")[i] for i in smps))
# --compare's whole waves: (label, scene, sampler), one 16-spp wave each
COMPARE_WAVES = tuple(
    (f"{scene} wave{' sobol' if smp == 'sobol' else ''}", scene, smp)
    for scene in ("fog_mesh", "fog") for smp in ("independent", "sobol")) \
    + (("deep_mesh wave", "deep_mesh", "independent"),
       ("textured_deep wave", "textured_deep", "independent"),
       ("big_mesh wave sobol", "big_mesh", "sobol"),
       ("cornell wave", "cornell", "independent"))
# the path mesh waves of COMPARE_WAVES that copies with the path lane
# loop's counts (csrc/path_loop.cuh PathCounts) also run through their
# counting build
PATH_COUNTED = ("deep_mesh wave", "textured_deep wave")
# --compare's K4 launch: the slice permutation of the deep mesh's
# 1280x720 x spw 16 state (label "K4 permute"), in turns with
# index_select over the 24 rows it permutes and over all 32 rows
K4_LABEL = "K4 permute"
# the mesh walk alone: pixels of the plain walk that records the rays,
# its maxdepth, the kinds of rays (`walk_rays`)
WALK_LANES = 1 << 17
WALK_DEPTH = 4
WALK_KINDS = ("camera", "bounce 1", "bounce 2", "bounce 3", "shadow")
# rays of a timed ray-cast probe launch: a kind's rays repeated
PROBE_MIN_RAYS = 1 << 22
# lanes of each K2 launch of a volpath main path that the plain version
# runs for the launch's bound (--main-launches)
PLAIN_LANES = 1 << 14
COMPARE_FILMS = {"cornell": (1024, 1024)}
COMPARE_FILM = (1280, 720)
COMPARE_ROUNDS = 2   # each a turn A, B, ..., B, A


def emit(**kw):
    print(json.dumps(kw), flush=True)


def scatter_share(path: str, seed: int = 1) -> float:
    """Share of the camera paths of the volpath scene at `path` that
    scatter in a medium at least once: one path per pixel through the
    plain volpath megakernel on the CPU."""
    from .integrators import volpath as V
    tabs = M.device_tables(P.pack_tables(*build_device_scene(
        load_scene(path))), "cpu")
    ever = torch.zeros(tabs["width"] * tabs["height"], dtype=torch.bool)
    bounce = V.bounce_vol

    def counting(*a, **kw):
        b = bounce(*a, **kw)
        ever.logical_or_(b["scattered"])
        return b
    V.bounce_vol = counting
    try:
        V.vol_lanes_ref(tabs, seed, 1)
    finally:
        V.bounce_vol = bounce
    return float(ever.double().mean())


def pack_sweep(dev, films=PACK_FILMS, runs=PACK_RUNS) -> list:
    """Sample-in-tile packing on the card. For each (scene, w, h) of
    `films` and each (spp, packs) of `runs`: the megakernel launch that
    delivers spp samples per pixel at each pack (spp // pack per lane),
    timed by CUDA events in PACK_ROUNDS rounds that take the packs in turn
    (kernel_ms: the median), its rays and Mrays/s; at the first spp also
    render() with RENE_MEGA_PACK set to the pack: Mrays/s and launches.
    Returns the rows, each also printed."""
    rows = []
    rounds = PACK_ROUNDS
    os.makedirs(SCENE_DIR, exist_ok=True)
    for name, w, h in films:
        path = os.path.join(SCENE_DIR, f"{name}_{w}x{h}.pbrt")
        with open(path, "w") as f:
            f.write(SCENES[name][0](SCENE_DIR, w, h))
        scene = load_scene(path)
        tabs = M.device_tables(P.pack_tables(*build_device_scene(scene)),
                               dev)
        for spp, packs in runs:
            ms = {p: [] for p in packs}
            rays = {p: [] for p in packs}
            for p in packs:
                kernels.mega_path(tabs, 5, spp // p, pack=p)   # warm-up
            for r in range(rounds):
                for p in packs:
                    t, o = time_launches(
                        lambda _, r=r, p=p: kernels.mega_path(
                            tabs, 7 + r, spp // p, pack=p), 1, dev)
                    ms[p].append(t)
                    rays[p].append(float(o[9].sum(dtype=torch.float64)))
                    del o
            for p in packs:
                row = {"scene": name, "film": [w, h], "spp": spp, "pack": p,
                       "lanes": w * h * p,
                       "resident_sets": w * h * p / M.RESIDENT_LANES,
                       "kernel_ms": sorted(ms[p])[len(ms[p]) // 2],
                       "kernel_ms_rounds": ms[p],
                       "rays": sum(rays[p]) / rounds}
                row["kernel_mrays_s"] = row["rays"] / row["kernel_ms"] / 1e3
                if spp == runs[0][0]:
                    row.update(render_row(scene, spp, p, dev))
                emit(pack_sweep=row)
                rows.append(row)
        del tabs
    return rows


def step_counts(tabs, dev, spp: int = 1, seed: int = 5) -> dict:
    """What divergence the volpath megakernel's lane loop leaves, from the
    counting build (kernels.mega_volpath_counts) at `spp`: the mean lanes
    of a warp active at the cast site (each warp's leader counts
    __popc(__activemask()) once per step), the loop steps per lane, the
    share of steps that are march segments; and the launch held to the
    uncounted build's at the same seed (rene_tpu_torch.checks)."""
    from . import checks
    out, c = kernels.mega_volpath_counts(tabs, seed, spp)
    ref = kernels.mega_path(tabs, seed, spp)
    torch.cuda.synchronize(dev)
    row = dict(c, spp=spp,
               mean_active_lanes=c["active_lanes"] / max(c["warp_steps"], 1),
               steps_per_lane=c["lane_steps"] / max(c["lanes"], 1),
               march_share=c["march_steps"] / max(c["lane_steps"], 1),
               agree_with_uncounted=checks.agreement(out, ref)["rad_frac"])
    emit(step_counts=row)
    return row


def walk_rays(tabs, dev, lanes: int = WALK_LANES, depth: int = WALK_DEPTH,
              seed: int = 5) -> dict:
    """The rays of the plain version's casts (ops.intersect.ray_log) on a
    strided sample of ~`lanes` pixels of the film at 1 spp, maxdepth
    `depth`: {kind: (n, RAY_W) rows} for WALK_KINDS (one path per lane,
    so the i-th closest cast of the walk is depth i) and "closest" (all
    of them)."""
    from .ops import intersect as X
    n_pix = tabs["width"] * tabs["height"]
    pix = torch.arange(0, n_pix, max(1, n_pix // lanes), device=dev)
    X.ray_log = []
    try:
        M.path_lanes_ref(dict(tabs, max_depth=depth), seed, 1, lanes=pix)
        log = X.ray_log
    finally:
        X.ray_log = None
    closest = [r for r in log if int(r[0, 8]) == X.CAST_CLOSEST]
    out = {k: closest[i].contiguous()
           for i, k in enumerate(WALK_KINDS[:-1]) if i < len(closest)}
    shadow = [r for r in log if int(r[0, 8]) == X.CAST_SHADOW]
    if shadow:
        out["shadow"] = torch.cat(shadow)
    out["closest"] = torch.cat(closest)
    return out


def walk_stats(counts: dict) -> dict:
    """Per-cast means of one kind's walk counts (kernels.WALK_KEYS)."""
    n = max(counts["casts"], 1)
    row = {k + "_per_cast": counts[k] / n
           for k in ("nodes", "boxes", "leaves", "tris", "insts", "blocks")}
    row.update(casts=counts["casts"], deepest_stack=counts["deepest_stack"],
               active_lanes=counts["active_lanes"]
               / max(counts["warp_steps"], 1),
               walk_steps_per_cast=counts["warp_steps"] / n,
               cycles_per_cast=counts["cycles"] / n)
    return row


def walk_share(counts: dict) -> float:
    """The walks' share of a counting launch's thread clock cycles."""
    return sum(counts[k]["cycles"] for k in kernels.CAST_KINDS) \
        / max(counts["lane_cycles"], 1)


def walk_report(tabs, dev, rays=None) -> dict:
    """The mesh walk of the big mesh alone (see the module's doc): per
    kind of `walk_rays` the probe's ms and Mrays/s and its counts; the
    counting build's counts over the 1- and 16-spp launches and the
    walks' share of the threads' clock cycles. Returns the rows, each
    also printed."""
    rays = rays or walk_rays(tabs, dev)
    rows = {}
    for kind, r in rays.items():
        ms, n = probe_ms(tabs, r, dev)
        _, c = kernels.cast_probe(tabs, r, counting=True)
        c = c["shadow" if kind == "shadow" else "closest"]
        row = dict(kind=kind, rays=r.shape[0], timed_rays=n, ms=ms,
                   mrays_s=n / ms / 1e3, ns_per_ray=ms * 1e6 / n,
                   **walk_stats(c))
        emit(walk=row)
        rows[kind] = row
    for spp in (1, 16):
        kernels.mega_path(tabs, 5, spp)   # warm-up
        ms = sorted(time_launches(lambda r: kernels.mega_path(
            tabs, 7 + r, spp), 1, dev)[0] for _ in range(3))[1]
        _, c = kernels.mega_path_walk_counts(tabs, 7, spp)
        row = {"launch_spp": spp, "launch_ms": ms,
               "walk_cycle_share": walk_share(c),
               **{k: walk_stats(c[k]) for k in kernels.CAST_KINDS}}
        emit(walk_launch=row)
        rows[f"launch {spp}"] = row
    return rows


def probe_ms(tabs, rays, dev, n_min: int = None):
    """(ms, rays cast) of one ray-cast probe launch over `rays` repeated
    up to at least `n_min` rows (PROBE_MIN_RAYS; so that the launch, not
    the host's argument checks, sets the time), by CUDA events, the
    median of three after a warm-up."""
    n_min = n_min or PROBE_MIN_RAYS
    big = rays.repeat(max(1, -(-n_min // rays.shape[0])), 1)
    kernels.cast_probe(tabs, big)
    ms = sorted(time_launches(lambda _: kernels.cast_probe(tabs, big), 1,
                              dev)[0] for _ in range(3))[1]
    return ms, big.shape[0]


def tex_rows(tabs, dev, lanes: int = WALK_LANES, depth: int = WALK_DEPTH,
             seed: int = 5) -> dict:
    """The fetches of the plain version (ops.texture.fetch_log) on a
    strided sample of ~`lanes` pixels of the film at 1 spp, maxdepth
    `depth` (camera hits and bounces 1-3, and the misses' background):
    {kind: (n, TEXP_W) rows} for each slot class (P.IMG_CLASSES) and the
    background ("bg") that fetched, and "all"."""
    from .ops import texture as TX
    n_pix = tabs["width"] * tabs["height"]
    pix = torch.arange(0, n_pix, max(1, n_pix // lanes), device=dev)
    TX.fetch_log = []
    try:
        M.path_lanes_ref(dict(tabs, max_depth=depth), seed, 1, lanes=pix)
        rows = torch.cat(TX.fetch_log)
    finally:
        TX.fetch_log = None
    out = {}
    for k, name in enumerate(P.IMG_CLASSES + ("bg",)):
        sel = rows[:, TX.TEXP_W] == k
        if bool(sel.any()):
            out[name] = rows[sel, :TX.TEXP_W].contiguous()
    out["all"] = rows[:, :TX.TEXP_W].contiguous()
    return out


def tex_report(tabs, dev) -> dict:
    """The texture fetch alone (kernels.tex_probe) on `tex_rows`, kind by
    kind: the share of fetches bit for bit equal to the plain fetch on the
    card, and Mfetches/s with the rows repeated to PROBE_MIN_RAYS per
    launch (CUDA events, median of three); then the counting build's
    texture counts over the 1- and 16-spp launches (`tex_stats`)."""
    from .ops import texture as TX
    res = {}
    for kind, rows in tex_rows(tabs, dev).items():
        got = kernels.tex_probe(tabs, rows)
        ref = TX.fetch_rows_ref(tabs["atlas"], rows)
        same = float((got.view(torch.int32) == ref.view(torch.int32))
                     .all(1).double().mean())
        big = rows.repeat(max(1, -(-PROBE_MIN_RAYS // rows.shape[0])), 1)
        kernels.tex_probe(tabs, big)
        ms = sorted(time_launches(lambda _: kernels.tex_probe(tabs, big), 1,
                                  dev)[0] for _ in range(3))[1]
        res[kind] = dict(fetches=rows.shape[0], timed=big.shape[0], ms=ms,
                         mfetches_s=big.shape[0] / ms / 1e3,
                         bit_equal=same)
        emit(tex_probe=kind, **res[kind])
    for spp in (1, 16):
        _, c = kernels.mega_path_tex_counts(tabs, 7, spp)
        res[f"counts {spp} spp"] = c
        emit(tex_counts_spp=spp, **tex_stats(c), counts=c)
    return res


def tex_stats(c: dict) -> dict:
    """Fetches per textured hit, the share of them that repeat the
    previous image class's, lanes active at each texture entry point, and
    the texture calls' share of the threads' cycles."""
    fetches = sum(c[f"fetch_{k}"] for k in P.IMG_CLASSES)
    hits = max(c["apply_lanes"], 1)
    return dict(
        fetches_per_hit=fetches / hits, repeat_share=c["fetch_repeat"]
        / max(fetches, 1), checkers_per_hit=c["checkers"] / hits,
        active_lanes={e: c[f"{e}_lanes"] / max(c[f"{e}_warps"], 1)
                      for e in kernels.TEX_ENTRIES},
        tex_cycle_share=c["tex_cycles"] / max(c["lane_cycles"], 1))


def path_stats(c: dict) -> dict:
    """The path immediates megakernel's phases as shares of the threads'
    cycles (the BSDF steps without their emitter-pdf casts; the rest is
    shading, the background, NEE and the lane loop) and the lane loop's
    warp efficiency: lane-bounces over 32 x each warp's busiest lane's."""
    lane = max(c["lane_cycles"], 1)
    share = {"trace_closest": c["trace_cycles"] / lane,
             "trace_emit_pdf": c["emit_pdf_cycles"] / lane,
             "sample_light_and_bsdf": (c["bsdf_cycles"]
                                       - c["emit_pdf_cycles"]) / lane,
             "draws": c["draw_cycles"] / lane}
    share["rest"] = 1.0 - sum(share.values())
    return dict(cycle_share=share,
                cycles_per_bounce=lane / max(c["lane_bounces"], 1),
                warp_efficiency=c["lane_bounces"]
                / max(c["warp_bounce_slots"], 1),
                bounces_per_lane=c["lane_bounces"] / max(c["lanes"], 1))


def sass_loops(lib_path, function: str = "cast_probe_kernel") -> list:
    """The loops of `function` in the SASS of the library (cuobjdump
    next to nvcc): per backward branch, the instructions from its target
    to it, counted by kind (global, shared and other loads, FP32 add / mul
    / fma, MUFU, calls, branches, the rest). A count of instructions, not
    a timing."""
    import re
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    loops = []
    for sec in text.split("Function : ")[1:]:
        if function not in sec.split("\n", 1)[0]:
            continue
        ins = []
        for line in sec.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)(.*?);", line)
            if m:
                ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) <= addr:
                body = [o for a, o, _ in ins
                        if int(t.group(1), 16) <= a <= addr]
                kinds = {"LDG": 0, "LDS": 0, "LD_other": 0, "FP32": 0,
                         "MUFU": 0, "CALL": 0, "BRA": 0, "other": 0}
                for o in body:
                    k = ("LDG" if o.startswith("LDG") else "LDS"
                         if o.startswith("LDS") else "LD_other"
                         if o.startswith(("LD", "ULDC")) else "FP32"
                         if o.split(".")[0] in ("FADD", "FMUL", "FFMA")
                         else "MUFU" if o.startswith("MUFU") else "CALL"
                         if o.startswith("CALL") else "BRA"
                         if o.startswith(("BRA", "BSSY", "BSYNC"))
                         else "other")
                    kinds[k] += 1
                loops.append(dict(function=sec.split("\n", 1)[0].strip(),
                                  start=hex(int(t.group(1), 16)),
                                  end=hex(addr), instructions=len(body),
                                  **kinds))
    return loops


def main_scene(scene: str, depth, sampler: str) -> str:
    """Path of the pbrt file of a MAIN_PATHS scene at its main film (the
    deep mesh: the big mesh at maxdepth 50)."""
    w, h = COMPARE_FILMS.get(scene, COMPARE_FILM)
    if scene == "deep_mesh":
        scene, depth = "big_mesh", depth or 50
    if scene == "textured_deep":
        scene, depth = "textured_mesh", depth or 50
    if scene == "big_mesh":
        src = scenes.big_mesh_scene(w, h, **({"maxdepth": depth} if depth
                                              else {}))
    elif scene == "textured_mesh":
        src = scenes.textured_mesh_scene(SCENE_DIR, w, h, **(
            {"maxdepth": depth} if depth else {}))
    elif scene == "fog":
        src = scenes.fog_scene(w, h)
    else:
        src = SCENES[scene][0](SCENE_DIR, w, h)
    path = os.path.join(SCENE_DIR, f"main_{scene}_{depth}_{sampler}.pbrt")
    with open(path, "w") as f:
        f.write(scenes.with_sampler(src) if sampler == "sobol" else src)
    return path


def main_launches(dev, paths=MAIN_PATHS, only=None) -> list:
    """Each kernel's time on its main path (see the module's doc), or on
    those whose label holds one of the strings in `only`; returns the
    rows, each also printed."""
    from .integrators import wave as WV
    os.makedirs(SCENE_DIR, exist_ok=True)
    rows = []
    for label, scene, depth, sampler, eng, spp, pack in paths:
        if only is not None and not any(o in label for o in only):
            continue
        bn, cfg = build_device_scene(load_scene(main_scene(scene, depth,
                                                           sampler)))
        row = {"main": label, "spp": spp, "pack": pack}
        if eng == "mega":
            tabs = M.device_tables(P.pack_tables(bn, cfg), dev)
            n = spp // pack
            kernels.mega_path(tabs, 5, n, pack=pack)   # warm-up
            ms = sorted(time_launches(
                lambda r: kernels.mega_path(tabs, 7 + r, n, pack=pack), 1,
                dev)[0] for _ in range(3))
            row.update(kernel=kernels.variant(tabs), launches=1, ms=ms[1],
                       ms_runs=ms)
            del tabs
        else:
            run = WV.make_wave_fn(bn, cfg, dev, spp_hint=spp, sort_mode=eng)
            run.run_dev(3, spp)   # warm-up
            torch.cuda.synchronize(dev)
            before = dict(kernels.launches)
            split = {}
            run.run_dev(5, spp, split=split)
            row.update(samples_per_wave=run.samples_per_wave,
                       device_ms=split, launches={
                           k: v - before[k] for k, v in kernels.launches.items()
                           if v != before[k]})
            with k2_record([], dev) as per:   # the same wave once more
                run.run_dev(5, spp)
            row.update(k2_ms_sum=sum(r["ms"] for r in per), per_launch=per)
            # its bound, launch by launch
            with k2_record([], dev, plain=PLAIN_LANES) as per:
                run.run_dev(5, spp)
            row.update(k2_bound_ms=sum(r["bound_ms"] for r in per),
                       per_launch_bound=[
                           {k: r[k] for k in ("bound_ms", "bound_by",
                                              "sampled", "plain_tests")
                            if k in r} for r in per])
            if eng == "gather" and kernels.library(kernels.variant(
                    run.tabs, "wave_path")) == "wave_path_mesh":
                # and the path lane loop's counts, launch by launch
                with k2_record([], dev, counting=True) as per:
                    run.run_dev(5, spp)
                row.update(per_launch_counts=[
                    dict(loop_stats(r), k=r["k"], ms_counting=r["ms"])
                    for r in per])
            del run
        emit(main_launch=row)
        rows.append(row)
    return rows


@contextlib.contextmanager
def k2_record(rows: list, dev, counting: bool = False, plain: int = 0):
    """kernels.wave_path wrapped inside the block, so that each K2 launch
    of a wave adds to `rows` its k, the lanes launched (nt * W_TILE), the
    lanes alive at its start and at its end, the lane-bounces done (the
    launch's rays over the scene's rays per bounce), and its device ms
    (CUDA events around the launch alone; the counts are taken outside
    them). `counting`: the launches run the counting build
    (kernels.wave_volpath_counts: volpath mesh tables, independent
    sampler; kernels.wave_path_counts: path mesh tables), whose counts
    join each row. `plain`: before each launch the
    plain version (wave_step_ref) runs a strided sample of about `plain`
    of its alive lanes, and the row gains the launch's bound
    (rene_tpu_torch.bounds): the state rows its alive lanes read and
    write, and the operations of the ray-cast tests and casts the sample
    counts, scaled to the alive lanes."""
    from . import bounds as B
    from .integrators import wave as WV
    inner, pending = kernels.wave_path, []

    def plain_bound(tabs, state, seed, launch, k, n_run, kb, base, rem,
                    beckmann, stream):
        alive = torch.nonzero(state[WV.WROW_ALIVE, :n_run] > 0.5).squeeze(1)
        if not alive.numel():
            return {"bound_ms": 0.0}
        idx = alive[::max(1, alive.numel() // plain)]
        sub = state.index_select(1, idx)
        rays0 = sub[WV.WROW_RAYS].double().sum()
        B.reset_counts()
        WV.wave_step_ref(tabs, sub, seed, launch, k, idx.numel(), kb, base,
                         rem, beckmann, stream)
        scale = alive.numel() / idx.numel()
        tests = {key: v * scale for key, v in B.plain_counts().items()}
        rows_moved = B.K2_VOL_ROWS if tabs["volpath"] else B.K2_ROWS
        t, by = B.bound(n_run * 4 + alive.numel() * rows_moved * 4,
                        B.cast_ops(tabs, float(sub[WV.WROW_RAYS].double()
                                               .sum() - rays0) * scale,
                                   tests))
        return {"bound_ms": t, "bound_by": by, "sampled": idx.numel(),
                "plain_tests": tests}

    def alive_rays(state, n_run):
        return ((state[WV.WROW_ALIVE, :n_run] > 0.5).sum(),
                state[WV.WROW_RAYS, :n_run].double().sum())

    def launch(tabs, state, seed, launch, k, n_run, kb, base, rem,
               beckmann=False, stream="mixed"):
        extra = plain_bound(tabs, state, seed, launch, k, n_run, kb, base,
                            rem, beckmann, stream) if plain else {}
        a0, r0 = alive_rays(state, n_run)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        counts = {}
        if counting:
            state, counts = (kernels.wave_volpath_counts if tabs["volpath"]
                             else kernels.wave_path_counts)(
                tabs, state, seed, launch, k, n_run, kb, base, rem, beckmann)
        else:
            inner(tabs, state, seed, launch, k, n_run, kb, base, rem,
                  beckmann, stream)
        e1.record()
        a1, r1 = alive_rays(state, n_run)
        pending.append((k, n_run, a0, a1, r1 - r0, M.ray_increment(tabs),
                        e0, e1, dict(counts, **extra)))
        return state

    kernels.wave_path = launch
    try:
        yield rows
    finally:
        kernels.wave_path = inner
        torch.cuda.synchronize(dev)
        for k, n_run, a0, a1, rays, inc, e0, e1, counts in pending:
            rows.append(dict(k=k, launched=n_run, alive_start=int(a0),
                             alive_end=int(a1), bounces=float(rays) / inc,
                             ms=e0.elapsed_time(e1), **counts))


def loop_stats(c: dict) -> dict:
    """What a K2 launch's path lane loop counts (kernels.LOOP_KEYS) say:
    the counts, the mean lanes of a warp active at the cast site, casts,
    bounces and parked lanes per lane run, the share of the bounces' distant
    lights that needed no shadow ray, and the casts' share of the threads'
    cycles."""
    lanes = max(c.get("lanes", 0), 1)
    lights = c.get("shadow_casts", 0) + c.get("shadows_skipped", 0)
    return dict({k: c[k] for k in kernels.LOOP_KEYS if k in c},
                mean_active_lanes=c.get("active_lanes", 0)
                / max(c.get("warp_casts", 0), 1),
                closest_per_lane=c.get("closest_casts", 0) / lanes,
                shadow_per_lane=c.get("shadow_casts", 0) / lanes,
                bounces_per_lane=c.get("lane_bounces", 0) / lanes,
                parked_share=c.get("parked", 0) / lanes,
                shadow_skip_share=c.get("shadows_skipped", 0)
                / max(lights, 1),
                cast_cycle_share=c.get("cast_cycles", 0)
                / max(c.get("lane_cycles", 0), 1))


def ptxas_lines(text: str) -> list:
    """The register and spill lines of an nvcc -Xptxas=-v report, each
    function's after its name."""
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln
            or "Function properties" in ln]


def compare_builds(dirs, dev, only=None) -> dict:
    """Time COMPARE_LAUNCHES with the libraries built from each csrc copy
    in `dirs`, in COMPARE_ROUNDS rounds that run the
    directories in turn and back (A, B, B, A); see the module's doc.
    `only`: the launches and waves whose label holds one of these strings
    (all where None). Returns {launch: {dir: row}}, each row also
    printed."""
    from . import checks

    def chosen(label):
        return only is None or any(o in label for o in only)
    launches = [c for c in COMPARE_LAUNCHES if chosen(c[0])]
    waves = [w for w in COMPARE_WAVES if chosen(w[0])]
    from .integrators import wave as WV
    from concurrent.futures import ThreadPoolExecutor
    # the libraries those launches and waves run, and the counting builds
    # of the copies that have them (csrc/vol_loop.cuh StepCounts, for the
    # fog mesh; csrc/bvh.cuh WalkCounts, for the big mesh)
    names = sorted({SCENE_LIBS[sc][spp == "k2"]
                    for _, sc, spp, _, _ in launches}
                   | {SCENE_LIBS[sc][1] for _, sc, _ in waves})
    scenes_run = {c[1] for c in launches} | {w[1] for w in waves}
    counting = [d for d in dirs if "fog_mesh" in scenes_run
                and os.path.exists(os.path.join(d, "vol_loop.cuh"))]
    walk_counting = [d for d in dirs if "big_mesh" in scenes_run
                     and "WalkCounts" in open(os.path.join(
                         d, "bvh.cuh")).read()]
    # csrc/path_loop.cuh PathCounts, for the deep and textured deep waves
    path_counting = [d for d in dirs
                     if any(w[0] in PATH_COUNTED for w in waves)
                     and os.path.exists(os.path.join(d, "path_loop.cuh"))]
    k4 = chosen(K4_LABEL)
    if k4:
        names = sorted(set(names) | {"wave_path"})
    jobs = [(d, names + [kernels.COUNT, kernels.WAVE_COUNT] * (d in counting)
             + [kernels.PATH_WAVE_COUNT] * (d in path_counting)
             + [kernels.WALK_COUNT] * (d in walk_counting)) for d in dirs]
    reports, seconds = {}, {}

    def build(job):
        t = time.perf_counter()
        kernels.build(verbose=True, csrc=job[0], names=job[1],
                      reports=reports)
        seconds[job[0]] = time.perf_counter() - t
    with ThreadPoolExecutor(len(dirs)) as ex:   # every build at once
        list(ex.map(build, jobs))
    for d, _ in jobs:
        emit(build=d, libraries=len(_), build_s=seconds[d])
    for (d, name), text in sorted(reports.items()):
        emit(build=d, library=name, ptxas=ptxas_lines(text))
    libs = {d: {n: kernels.load_library(n, d) for n in ns} for d, ns in jobs}
    os.makedirs(SCENE_DIR, exist_ok=True)
    tabs_of, runs = {}, {}
    for _, scene, spp, _, sampler in launches:
        key = (scene, sampler)
        if key in tabs_of and (spp != "k2" or key in runs):
            continue
        bn, cfg = build_device_scene(load_scene(main_scene(scene, None,
                                                           sampler)))
        if key not in tabs_of:
            tabs_of[key] = M.device_tables(P.pack_tables(bn, cfg), dev)
        if spp == "k2":
            runs[key] = WV.make_wave_fn(bn, cfg, dev, spp_hint=16)
    res = {}
    saved = dict(kernels._libs)
    try:
        for label, scene, spp, pack, sampler in launches:
            tabs = tabs_of[scene, sampler]
            states = []   # a K2 launch's inputs, copied before its timing
            if spp == "k2":
                run = runs[scene, sampler]
                s0 = run.init_state(3, run.samples_per_wave)
                n_run = -(-run.n_real // WV.W_TILE) * WV.W_TILE
                lib = kernels.library(kernels.variant(tabs, "wave_path"))

                def fn(r=0):
                    return kernels.wave_path(
                        tabs, states[r] if states else s0.clone(), 3, 0,
                        WV.SCHEDULE[0], n_run, run.key_bounds, 1, 0)
                reps, rays_row = 5, WV.WROW_RAYS
            else:
                lib = kernels.library(kernels.variant(tabs))

                def fn(r=0):
                    return kernels.mega_path(tabs, 7 + r, spp, pack=pack)
                reps, rays_row = (1 if spp > 4 else 3), 9
            ms = {d: [] for d in dirs}
            outs = {}
            for d in dirs:   # warm-up, and each build's output at seed 7
                kernels._libs[lib] = libs[d][lib]
                outs[d] = fn()
                torch.cuda.synchronize(dev)
            order = list(dirs) + list(reversed(dirs))
            for _ in range(COMPARE_ROUNDS):
                for d in order:
                    kernels._libs[lib] = libs[d][lib]
                    if spp == "k2":
                        states[:] = [s0.clone() for _ in range(reps)]
                    ms[d].append(time_launches(fn, reps, dev)[0])
                    states.clear()
            res[label] = {}
            for d in dirs:
                out = outs[d]
                if spp == "k2":
                    rays = float((out[rays_row] - s0[rays_row]).sum())
                    agree = float((out == outs[dirs[0]]).all(0).double()
                                  .mean())
                else:
                    rays = float(out[rays_row].sum(dtype=torch.float64))
                    agree = checks.agreement(out, outs[dirs[0]])["rad_frac"]
                row = {"launch": label, "dir": str(d), "library": lib,
                       "ms": sorted(ms[d])[len(ms[d]) // 2],
                       "ms_turns": ms[d], "rays": rays,
                       "ns_per_ray": sorted(ms[d])[len(ms[d]) // 2] * 1e6
                       / max(rays, 1.0),
                       "agree_with_first": agree}
                emit(compare=row)
                res[label][str(d)] = row
            del outs
        res.update(compare_waves(dirs, libs, dev, counting, waves,
                                 path_counting))
        if k4:
            res.update(compare_permute(dirs, libs, dev))
        big = tabs_of.get(("big_mesh", "independent"))
        if big is not None and "mega_path_mesh" in libs[dirs[0]]:
            res.update(compare_walk(dirs, libs, big, dev))
        for d in walk_counting if big is not None \
                and "mega_path_mesh" in libs[dirs[0]] else ():
            kernels._libs[kernels.WALK_COUNT] = libs[d][kernels.WALK_COUNT]
            _, c = kernels.mega_path_walk_counts(big, 7, 16)
            emit(walk_counts_of=str(d), launch="big_mesh 16 spp",
                 walk_cycle_share=walk_share(c),
                 **{k: walk_stats(c[k]) for k in kernels.CAST_KINDS})
        tabs = tabs_of.get(("fog_mesh", "independent"))
        for d in counting if tabs is not None else ():
            kernels._libs.update(libs[d])
            emit(step_counts_of=str(d))
            res.setdefault("step_counts", {})[str(d)] = step_counts(tabs, dev)
    finally:
        kernels._libs.clear()
        kernels._libs.update(saved)
    return res


def compare_walk(dirs, libs, tabs, dev) -> dict:
    """compare_builds' mesh walk: each kind of `walk_rays` on the big mesh
    `tabs` through each directory's ray-cast probe (its mega_path_mesh
    library swapped in), in COMPARE_ROUNDS rounds that run the
    directories in turn and back; per directory the median ms, Mrays/s
    and the share of rays whose results equal the first directory's.
    Returns {"walk <kind>": {dir: row}}, each row also printed."""
    lib = "mega_path_mesh"
    res = {}
    for kind, rays in walk_rays(tabs, dev).items():
        outs, ms = {}, {d: [] for d in dirs}
        for d in dirs:
            kernels._libs[lib] = libs[d][lib]
            outs[d] = kernels.cast_probe(tabs, rays)
        rays = rays.repeat(max(1, -(-PROBE_MIN_RAYS // rays.shape[0])), 1)
        for _ in range(COMPARE_ROUNDS):
            for d in list(dirs) + list(reversed(dirs)):
                kernels._libs[lib] = libs[d][lib]
                ms[d].append(time_launches(
                    lambda _: kernels.cast_probe(tabs, rays), 1, dev)[0])
        res["walk " + kind] = {}
        for d in dirs:
            m = sorted(ms[d])[len(ms[d]) // 2]
            row = {"launch": "walk " + kind, "dir": str(d), "rays":
                   rays.shape[0], "ms": m, "ms_turns": ms[d],
                   "mrays_s": rays.shape[0] / m / 1e3,
                   "agree_with_first": float((outs[d] == outs[dirs[0]])
                                             .all(1).double().mean())}
            emit(compare=row)
            res["walk " + kind][str(d)] = row
    return res


def compare_permute(dirs, libs, dev) -> dict:
    """compare_builds' K4: each directory's wave_permute (its wave_path
    library swapped in) on the deep mesh's 1280x720 x spw 16 state and a
    random slice permutation, in COMPARE_ROUNDS rounds that run the
    directories in turn and back, each turn followed by torch's
    index_select over the 24 rows K4 permutes (the PyTorch call of
    chip_smoke.py's library_ms) and over all 32 rows of the state (the
    bytes K4 moves; its AOV rows then move too); 10 launches a turn, CUDA
    events. Per directory the median ms, whether its output equals
    permute_ref bit for bit, and the bound; returns {K4_LABEL: {dir or
    call: row}}, each row also printed."""
    from . import bounds as B
    from .integrators import wave as WV
    bn, cfg = build_device_scene(load_scene(main_scene("deep_mesh", None,
                                                       "independent")))
    run = WV.make_wave_fn(bn, cfg, dev, spp_hint=16)
    state = run.init_state(3, run.samples_per_wave)
    ns = run.n_pad // WV.W_SLICE
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    perm = torch.randperm(ns, device=dev, generator=g).to(torch.int32)
    ref = WV.permute_ref(state, perm)
    p64 = perm.long()
    rows24 = state[:WV.W_SORT_PAD].view(WV.W_SORT_PAD, ns, WV.W_SLICE)
    rows32 = state.view(WV.W_NROWS, ns, WV.W_SLICE)
    calls = {"index_select 24 rows": lambda r: torch.index_select(
        rows24, 1, p64), "index_select 32 rows": lambda r: torch.index_select(
        rows32, 1, p64)}
    bnd = B.bound(2 * WV.W_NROWS * 4 * run.n_pad + 4 * ns, 0)
    ms = {k: [] for k in list(dirs) + list(calls)}
    equal = {}
    for d in dirs:   # warm-up, and each build's output
        kernels._libs["wave_path"] = libs[d]["wave_path"]
        equal[d] = bool(torch.equal(kernels.wave_permute(state, perm), ref))
    del ref
    for _ in range(COMPARE_ROUNDS):
        for d in list(dirs) + list(reversed(dirs)):
            kernels._libs["wave_path"] = libs[d]["wave_path"]
            ms[d].append(time_launches(
                lambda r: kernels.wave_permute(state, perm), 10, dev)[0])
            for k, fn in calls.items():
                ms[k].append(time_launches(fn, 10, dev)[0])
    res = {}
    for k, turns in ms.items():
        m = sorted(turns)[len(turns) // 2]
        row = {"launch": K4_LABEL, "dir": str(k), "lanes": run.n_pad,
               "ms": m, "ms_turns": turns, "bound_ms": bnd[0],
               "bound_share": bnd[0] / m}
        if k in equal:
            row["equal_to_plain"] = equal[k]
        emit(compare=row)
        res[str(k)] = row
    return {K4_LABEL: res}


def compare_waves(dirs, libs, dev, counting=(), waves=COMPARE_WAVES,
                  path_counting=()) -> dict:
    """compare_builds' whole waves (COMPARE_WAVES): each directory's K2
    library swapped in for one 16-spp wave at seed 5, in COMPARE_ROUNDS
    rounds that run the directories in turn and back, each wave's K2
    launches timed one by one (k2_record); per directory the median of
    the summed K2 ms, each launch's median, and the finished film's
    per-pixel agreement with the first directory's (and whether it is
    bit for bit the same). For the copies in `counting`, the fog mesh
    wave once more through the counting build, its counts per launch; for
    those in `path_counting`, the PATH_COUNTED waves through theirs.
    Returns {label: {dir: row}}, each row also printed."""
    from . import checks
    from .integrators import wave as WV

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    res = {}
    for label, scene, sampler in waves:
        bn, cfg = build_device_scene(load_scene(main_scene(scene, None,
                                                           sampler)))
        run = WV.make_wave_fn(bn, cfg, dev, spp_hint=16)
        lib = kernels.library(kernels.variant(run.tabs, "wave_path"))
        films, turns = {}, {d: [] for d in dirs}
        for d in dirs:   # warm-up, and each build's film
            kernels._libs[lib] = libs[d][lib]
            films[d] = run.run_dev(5, 16)
        for _ in range(COMPARE_ROUNDS):
            for d in list(dirs) + list(reversed(dirs)):
                kernels._libs[lib] = libs[d][lib]
                with k2_record([], dev) as rows:
                    run.run_dev(5, 16)
                turns[d].append(rows)
        res[label] = {}
        for d in dirs:
            (sums, rays), (sums0, rays0) = films[d], films[dirs[0]]
            a = checks.agreement(sums, sums0)
            row = {"launch": label, "dir": str(d), "library": lib,
                   "k2_ms": median([sum(r["ms"] for r in t)
                                    for t in turns[d]]),
                   "k2_ms_turns": [sum(r["ms"] for r in t)
                                   for t in turns[d]],
                   "k": [r["k"] for r in turns[d][0]],
                   "launch_ms": [median(ms) for ms in zip(
                       *[[r["ms"] for r in t] for t in turns[d]])],
                   "agree_with_first": a["rad_frac"],
                   "aov_agree_with_first": a["aov_frac"],
                   "mean_rel": a["mean_rel"],
                   "bit_equal": bool(torch.equal(sums, sums0))
                   and float(rays) == float(rays0)}
            emit(compare=row)
            res[label][str(d)] = row
        if label == "fog_mesh wave":
            for d in counting:
                kernels._libs[kernels.WAVE_COUNT] = libs[d][kernels.WAVE_COUNT]
                with k2_record([], dev, counting=True) as rows:
                    run.run_dev(5, 16)
                emit(wave_counts_of=str(d), per_launch=rows)
        if label in PATH_COUNTED:
            for d in path_counting:
                kernels._libs[kernels.PATH_WAVE_COUNT] = \
                    libs[d][kernels.PATH_WAVE_COUNT]
                with k2_record([], dev, counting=True) as rows:
                    run.run_dev(5, 16)
                emit(wave_counts_of=str(d), wave=label, per_launch=[
                    dict(loop_stats(r), k=r["k"], ms_counting=r["ms"])
                    for r in rows])
        del run, films
    return res


def time_launches(fn, reps, dev):
    """Milliseconds per call of fn(r), r = 0 .. reps - 1, by CUDA events,
    and the last call's result."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        out = fn(r)
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps, out


@contextlib.contextmanager
def mega_pack(pack: int):
    """RENE_MEGA_PACK set to `pack` inside the block, as it was after."""
    before = os.environ.get("RENE_MEGA_PACK")
    os.environ["RENE_MEGA_PACK"] = str(pack)
    try:
        yield
    finally:
        if before is None:
            del os.environ["RENE_MEGA_PACK"]
        else:
            os.environ["RENE_MEGA_PACK"] = before


def render_row(scene, spp, pack, dev) -> dict:
    """render() of `scene` at `spp` with RENE_MEGA_PACK set to `pack`:
    its Mrays/s and launches."""
    with mega_pack(pack):
        out = render(scene, spp=spp, seed=3, device=dev)
    return {"render_mrays_s": out["total_rays"] / out["wall_time"] / 1e6,
            "render_launches": out["launches"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m rene_tpu_torch.probe")
    p.add_argument("--scene", choices=sorted(SCENES), default="cornell")
    p.add_argument("--out", default=os.path.join("chiprun_out", "probe"))
    p.add_argument("--scatter-share", action="store_true")
    p.add_argument("--pack-sweep", action="store_true")
    p.add_argument("--compare", nargs="+", metavar="DIR")
    p.add_argument("--only", nargs="+", metavar="LABEL",
                   help="--compare, --main-launches: only the launches, "
                        "waves and main paths whose label holds one of "
                        "these")
    p.add_argument("--main-launches", action="store_true")
    args = p.parse_args(argv)
    make, (w, h), spps, chunks = SCENES[args.scene]
    if args.scatter_share:
        os.makedirs(SCENE_DIR, exist_ok=True)
        path = os.path.join(SCENE_DIR, f"{args.scene}_share.pbrt")
        with open(path, "w") as f:
            f.write(make(SCENE_DIR, *SHARE_FILM))
        t = time.perf_counter()
        share = scatter_share(path)
        emit(scene=args.scene, film=SHARE_FILM, spp=1, scatter_share=share,
             plain_cpu_s=time.perf_counter() - t)
        return 0
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    emit(card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    if args.pack_sweep:
        pack_sweep(torch.device("cuda", 0))
        return 0
    if args.main_launches:
        main_launches(torch.device("cuda", 0), only=args.only)
        return 0
    if args.compare:
        compare_builds([os.path.abspath(d) for d in args.compare],
                       torch.device("cuda", 0), args.only)
        return 0
    os.makedirs(SCENE_DIR, exist_ok=True)
    path = os.path.join(SCENE_DIR, f"{args.scene}.pbrt")
    with open(path, "w") as f:
        f.write(make(SCENE_DIR, w, h))
    kernels.build()
    dev = torch.device("cuda", 0)

    def timed(fn):
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize(dev)
        return r, time.perf_counter() - t

    _, t_ctx = timed(lambda: torch.zeros(1, device=dev))
    with trace.profiled() as prof:    # the host phases' spans
        scene, t_load = timed(lambda: load_scene(path))
        (bn, cfg), t_bds = timed(lambda: build_device_scene(scene))
        tables, t_pack = timed(lambda: P.pack_tables(bn, cfg))
        tabs, t_up = timed(lambda: M.device_tables(tables, dev))
    emit(cuda_context_s=t_ctx, load_scene_s=t_load,
         build_device_scene_s=t_bds, pack_tables_s=t_pack, upload_s=t_up,
         bvh_binary_s=trace.seconds(prof, "rene.tables.bvh"),
         bvh_wide_s=trace.seconds(prof, "rene.tables.wide"),
         wide_nodes=int(tables.wnodes.shape[0]),
         binary_nodes=int(tables.nodes.shape[0]),
         walk_need=tables.walk_need)

    timed(lambda: kernels.mega_path(tabs, 1, 1))   # warm-up
    for spp in spps:
        out = render(scene, spp=spp, seed=3, device=dev)
        emit(spp=spp, rays=out["total_rays"], wall_s=out["wall_time"],
             mrays_s=out["total_rays"] / out["wall_time"] / 1e6,
             launches=out["launches"], mean=float(out["color"].mean()))
    _, t_png = timed(lambda: save_png(
        os.path.join(args.out, f"{args.scene}.png"), to_rgb8(out["color"])))
    emit(png_encode_s=t_png)

    def chunk(tabs, spp, **tag):
        timed(lambda: kernels.mega_path(tabs, 5, spp))
        ms, o = time_launches(lambda r: kernels.mega_path(tabs, 7 + r, spp),
                              5, dev)
        rays = float(o[9].sum(dtype=torch.float64))
        emit(chunk_spp=spp, kernel_ms=ms, rays=rays,
             kernel_mrays_s=rays / ms / 1e3, ns_per_ray=ms * 1e6 / rays,
             **tag)

    for spp in chunks:
        chunk(tabs, spp)
    if args.scene == "big_mesh":
        walk_report(tabs, dev)
    if args.scene == "textured_mesh":
        tex_report(tabs, dev)
    if args.scene == "cornell":
        for spp in (1, 64):   # one path per lane, and the main path's
            _, c = kernels.mega_path_counts(tabs, 7, spp)
            emit(path_counts_spp=spp, **path_stats(c), counts=c)
        rays = walk_rays(tabs, dev)["closest"]
        ms, n = probe_ms(tabs, rays, dev)
        emit(imm_cast_probe="closest", rays=n, ms=ms, mrays_s=n / ms / 1e3)
        for loop in sass_loops(kernels.library_path("mega_path")):
            emit(sass_loop=loop)
    if tabs["has_tex"] or tabs["bg_kind"] != P.BG_CONST:
        no_env = dict(tabs, has_env=False, **{
            k: tabs[k][:0] for k in ("env_mcdf", "env_ccdf", "env_pdf",
                                     "env_guide")})
        cam = tabs["cam"].clone()
        cam[P.CAM_BG_KIND] = P.BG_CONST
        for off, t in (("material textures", dict(tabs, has_tex=False)),
                       ("env-map light sampling", no_env),
                       ("background fetch", dict(tabs, cam=cam)),
                       ("all three", dict(no_env, has_tex=False, cam=cam))):
            chunk(t, 4, without=off)

    if tabs["volpath"] and kernels.variant(tabs) == "mega_volpath_mesh":
        for spp in (1, spps[0]):   # one path per lane, and the main path's
            step_counts(tabs, dev, spp)

    if tabs["volpath"]:
        from .integrators.wave import make_wave_fn
        run = make_wave_fn(bn, cfg, dev, spp_hint=spps[0])
        run.read_back(run.run_dev(3, spps[0]))   # warm-up
        split = {}
        t = time.perf_counter()
        out = run.read_back(run.run_dev(5, spps[0], split=split))
        emit(wave_spp=spps[0], samples_per_wave=run.samples_per_wave,
             wall_s=time.perf_counter() - t, rays=out["rays"],
             device_ms=split)
        if kernels.variant(tabs, "wave_path") == "wave_volpath_mesh":
            with k2_record([], dev, counting=True) as rows:
                run.run_dev(5, spps[0])
            emit(wave_counts=rows)

    with trace.profiled(os.path.join(
            args.out, f"{args.scene}_render{spps[0]}_trace.json")) as prof:
        _, wall = timed(lambda: render(scene, spp=spps[0], seed=9,
                                       device=dev))
    rows = []
    for k in prof.key_averages():
        dt = getattr(k, "device_time_total", None)
        if dt is None:
            dt = getattr(k, "cuda_time_total", 0)
        if dt and not k.key.startswith("rene."):   # operations, not spans
            rows.append({"op": k.key[:90], "device_us": dt, "n": k.count})
    rows.sort(key=lambda r: -r["device_us"])
    emit(profiled_spp=spps[0], wall_s=wall, top=rows[:12])
    return 0


if __name__ == "__main__":
    sys.exit(main())
