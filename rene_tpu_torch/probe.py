"""Where a main-path render's time goes, on a CUDA card.

    python -m rene_tpu_torch.probe [--scene cornell|big_mesh|textured_mesh|
                                            fog_mesh] [--out DIR]
    python -m rene_tpu_torch.probe --scene fog_mesh --scatter-share
    python -m rene_tpu_torch.probe --pack-sweep

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
  scene load, `build_device_scene`, `pack_tables` (with the BVH builds),
  the tables' upload;
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
* for a volpath scene, a wave of the wave engine at the smallest render
  spp, its device time split into init (K3), K2 launches, sorts and
  finish;
* a render at the smallest of those spp under torch.profiler: wall time
  and the operations with the most device time; the Chrome trace goes to
  DIR.

Needs a CUDA device and nvcc; it builds the kernels on first use.

`--pack-sweep` measures sample-in-tile packing (K1f) instead: the big
mesh at 1280x720, 320x180 and 160x90 and the fog mesh at 1280x720 and
320x180, each at pack 1, 4 and 16 delivering 16 spp, and at pack 1 and
64 delivering 64 spp (`pack_sweep`).

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

from . import kernels, scenes
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
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    o = kernels.mega_path(tabs, 7 + r, spp // p, pack=p)
                    end.record()
                    rays[p].append(o[9].sum(dtype=torch.float64))
                    torch.cuda.synchronize(dev)
                    ms[p].append(start.elapsed_time(end))
                    del o
            for p in packs:
                row = {"scene": name, "film": [w, h], "spp": spp, "pack": p,
                       "lanes": w * h * p,
                       "resident_sets": w * h * p / M.RESIDENT_LANES,
                       "kernel_ms": sorted(ms[p])[len(ms[p]) // 2],
                       "kernel_ms_rounds": ms[p],
                       "rays": float(sum(float(x) for x in rays[p])
                                     / rounds)}
                row["kernel_mrays_s"] = row["rays"] / row["kernel_ms"] / 1e3
                if spp == runs[0][0]:
                    row.update(render_row(scene, spp, p, dev))
                emit(pack_sweep=row)
                rows.append(row)
        del tabs
    return rows


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
    scene, t_load = timed(lambda: load_scene(path))
    (bn, cfg), t_bds = timed(lambda: build_device_scene(scene))
    tables, t_pack = timed(lambda: P.pack_tables(bn, cfg))
    tabs, t_up = timed(lambda: M.device_tables(tables, dev))
    emit(cuda_context_s=t_ctx, load_scene_s=t_load,
         build_device_scene_s=t_bds, pack_tables_s=t_pack, upload_s=t_up)

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
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for r in range(5):
            o = kernels.mega_path(tabs, 7 + r, spp)
        end.record()
        torch.cuda.synchronize(dev)
        ms = start.elapsed_time(end) / 5
        rays = float(o[9].sum(dtype=torch.float64))
        emit(chunk_spp=spp, kernel_ms=ms, rays=rays,
             kernel_mrays_s=rays / ms / 1e3, ns_per_ray=ms * 1e6 / rays,
             **tag)

    for spp in chunks:
        chunk(tabs, spp)
    if tabs["has_tex"] or tabs["bg_kind"] != P.BG_CONST:
        no_env = dict(tabs, has_env=False, **{
            k: tabs[k][:0] for k in ("env_mcdf", "env_ccdf", "env_pdf")})
        cam = tabs["cam"].clone()
        cam[P.CAM_BG_KIND] = P.BG_CONST
        for off, t in (("material textures", dict(tabs, has_tex=False)),
                       ("env-map light sampling", no_env),
                       ("background fetch", dict(tabs, cam=cam)),
                       ("all three", dict(no_env, has_tex=False, cam=cam))):
            chunk(t, 4, without=off)

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

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: render(scene, spp=spps[0], seed=9,
                                       device=dev))
    rows = []
    for k in prof.key_averages():
        dt = getattr(k, "device_time_total", None)
        if dt is None:
            dt = getattr(k, "cuda_time_total", 0)
        if dt:
            rows.append({"op": k.key[:90], "device_us": dt, "n": k.count})
    rows.sort(key=lambda r: -r["device_us"])
    emit(profiled_spp=spps[0], wall_s=wall, top=rows[:12])
    prof.export_chrome_trace(os.path.join(
        args.out, f"{args.scene}_render{spps[0]}_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
