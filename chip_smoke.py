#!/usr/bin/env python3
"""GPU smoke run of rene_tpu_torch, the PyTorch/CUDA port of rene-tpu.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits nonzero without printing a result
when either is missing or any check fails. Phases:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. the build of csrc/mega_path.cu with nvcc, both kernel variants at once
   (timed, ptxas registers and spills shown);
3. the K1a variant vs its plain version on the card: an inline 128x64
   scene with all 8 material types, emissive sphere and quad, a distant
   light and the tent filter at maxdepth 16, 4 spp, the same seed for both;
4. the K1a main path: `python -m rene_tpu_torch.cli` on an inline Cornell
   box at 1024x1024 and 64 spp, with normal and albedo AOVs;
5. that path's kernel launch against the plain version: the 64-spp chunk
   over 1024x1024 (128 TPU-sized tiles of lanes) with the CLI's chunk
   seed, held to the same limits as phase 3; then timing of the kernel
   and the plain version at the main path's shape (a 1-spp chunk);
6. the mesh variant vs its plain version on the card, 128x64 x 4 spp:
   the eight materials on a 2,310-triangle mesh, 12 shared-BLAS
   instances, and 100 table spheres with 24 table lights;
7. the mesh main path through the CLI: `scenes.big_mesh_scene`, a
   131,072-triangle surface plus 8 instances of a 4,096-triangle sphere,
   at 1280x720 x 16 spp with normal and albedo AOVs;
8. that path's launch shape against the plain version: one 1-spp chunk
   at 1280x720 with the CLI's chunk seed; then timing of the kernel
   (CUDA events) and the plain version at that shape.

The per-pixel rule and the card's limits are rene_tpu_torch.checks'. Each
main path (phases 4 and 7) runs with every launch count set to 0 just
before it and read just after; comparison launches are not counted.

Outputs go to chiprun_out/smoke/ of the checkout. The line before the
last is a JSON object describing each kernel; the last line is
{"ok": true, "device": {...}}.
"""
import json
import logging
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "smoke")
MAIN_SPP, MAIN_SEED = 64, 1
MESH_SPP, MESH_W, MESH_H = 16, 1280, 720


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def write_scene(name, src):
    path = os.path.join(OUT_DIR, name + ".pbrt")
    with open(path, "w") as f:
        f.write(src)
    return path


def tables_for(path, device):
    from rene_tpu_torch.integrators import mega_path as M
    from rene_tpu_torch.scene import build_device_scene, load_scene
    from rene_tpu_torch.scene import pack as P
    buffers_np, config = build_device_scene(load_scene(path))
    return M.device_tables(P.pack_tables(buffers_np, config), device)


def cli_path(name, src, spp, size, what):
    """Render `src` through cli.main on the card with every launch count
    set to 0 just before; check the PNG shapes and a non-black image.
    Returns (scene path, launch counts, Mrays/s line values)."""
    import torch
    from rene_tpu_torch import cli, kernels
    from rene_tpu_torch.utils.film import read_png
    scene_path = write_scene(name, src)
    paths = [os.path.join(OUT_DIR, f"{name}{k}.png")
             for k in ("", "_normal", "_albedo")]
    for p in paths:
        if os.path.exists(p):
            os.unlink(p)
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record)

    grab = Grab()
    logging.getLogger("rene_tpu_torch").addHandler(grab)
    for k in kernels.launches:
        kernels.launches[k] = 0
    t0 = time.time()
    rc = cli.main([scene_path, "--spp", str(spp), "--seed", str(MAIN_SEED),
                   "--output", paths[0], "--aov-normal", paths[1],
                   "--aov-albedo", paths[2], "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.launches)
    logging.getLogger("rene_tpu_torch").removeHandler(grab)
    if rc != 0:
        raise RuntimeError(f"cli returned {rc}")
    wrote = [r for r in records if r.getMessage().startswith("wrote ")]
    if not wrote:
        raise RuntimeError("cli logged no result")
    mrays, render_s, rate = wrote[-1].args[1:4]
    means = {}
    for p in paths:
        img = read_png(p)
        if img.shape != (size[1], size[0], 3):
            raise RuntimeError(f"{p}: shape {img.shape}")
        means[os.path.basename(p)] = float(img.mean())
    if not means[f"{name}.png"] > 0.0:
        raise RuntimeError("the rendered image is black")
    log(f"main path ({what}, {spp} spp): launches {json.dumps(launches)}, "
        f"{mrays:.1f} Mrays, render {render_s:.3f} s, {rate:.1f} Mrays/s, "
        f"cli wall {wall:.3f} s, png means {json.dumps(means)}")
    return scene_path, launches


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from rene_tpu_torch import checks, kernels, scenes
    from rene_tpu_torch.integrators import mega_path as M

    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda", 0)

    # 1. the card
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # 2. build, both variants at once
    t0 = time.time()
    sos = kernels.build(verbose=True)
    log(f"build: {time.time() - t0:.1f} s -> "
        + ", ".join(os.path.relpath(so, ROOT) for so in sos.values()))

    def compare(tabs, seed, spp, what):
        """The kernel and its plain version on the same tables and seed,
        held to the card's limits; returns the agreement."""
        out_k = kernels.mega_path(tabs, seed, spp)
        torch.cuda.synchronize()
        t = time.time()
        out_p = M.path_lanes_ref(tabs, seed, spp)
        torch.cuda.synchronize()
        plain_s = time.time() - t
        if not bool(torch.isfinite(out_k).all()):
            raise RuntimeError(f"{what}: kernel output is not finite")
        a = checks.agreement(out_k, out_p)
        log(f"kernel vs plain ({what}, seed {seed}, plain {plain_s:.1f} s): "
            + json.dumps(a))
        checks.check_card(a, what)
        a["plain_s"] = plain_s
        return a

    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for r in range(reps):
            fn(r)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def chunk_seed():
        # the seed render.py draws for the first chunk
        return int(np.random.default_rng(MAIN_SEED).integers(
            0, 2 ** 31, dtype=np.int32))

    # 3. K1a kernel vs plain on the card
    tabs = tables_for(
        write_scene("materials", scenes.materials_scene(128, 64)), dev)
    a_mat = compare(tabs, 1234567, 4, "materials 128x64 x 4 spp")

    # 4. the K1a main path through the CLI
    scene_path, l_k1a = cli_path("cornell", scenes.cornell_box(1024, 1024),
                                 MAIN_SPP, (1024, 1024), "cornell 1024x1024")
    if l_k1a["mega_path"] <= 0 or l_k1a["mega_path_mesh"] != 0:
        raise RuntimeError(f"the K1a main path launched {l_k1a}")

    # 5. that path's launch vs plain, then timing at a 1-spp chunk
    tabs = tables_for(scene_path, dev)
    a_main = compare(tabs, chunk_seed(), MAIN_SPP,
                     f"cornell 1024x1024 x {MAIN_SPP} spp")
    k1a_ms = time_ms(lambda r=0: kernels.mega_path(tabs, 11 + r, 1), 20)
    k1a_plain_ms = time_ms(lambda r=0: M.path_lanes_ref(tabs, 11 + r, 1), 2)
    log(f"timing (cornell 1024x1024, 1 spp): kernel {k1a_ms:.3f} ms, "
        f"plain {k1a_plain_ms:.1f} ms [{card}]")
    del tabs

    # 6. the mesh variant vs plain on the card
    a_mesh = []
    for name, src in (
            ("mesh_materials", scenes.mesh_materials_scene(128, 64)),
            ("instanced", scenes.instanced_scene(128, 64)),
            ("sphere_light", scenes.sphere_light_scene(128, 64, 100, 24))):
        tabs = tables_for(write_scene(name, src), dev)
        if kernels.variant(tabs) != "mega_path_mesh":
            raise RuntimeError(f"{name}: not a mesh-variant scene")
        a_mesh.append(compare(tabs, 1234567, 4, f"{name} 128x64 x 4 spp"))

    # 7. the mesh main path through the CLI
    t0 = time.time()
    src = scenes.big_mesh_scene(MESH_W, MESH_H)
    log(f"big_mesh_scene text: {len(src) / 1e6:.1f} MB in "
        f"{time.time() - t0:.2f} s")
    scene_path, l_mesh = cli_path("big_mesh", src, MESH_SPP,
                                  (MESH_W, MESH_H),
                                  f"big mesh {MESH_W}x{MESH_H}")
    if l_mesh["mega_path_mesh"] <= 0 or l_mesh["mega_path"] != 0:
        raise RuntimeError(f"the mesh main path launched {l_mesh}")

    # 8. that path's launch shape vs plain, then timing
    t0 = time.time()
    tabs = tables_for(scene_path, dev)
    log(f"big mesh tables: {time.time() - t0:.2f} s, "
        f"{tabs['mesh'].shape[0]} mesh triangles, {tabs['nodes'].shape[0]} "
        f"nodes, {tabs['insts'].shape[0]} instances, BVH depth "
        f"{tabs['bvh_depth']}")
    a_big = compare(tabs, chunk_seed(), 1, f"big mesh {MESH_W}x{MESH_H} x 1 spp")
    mesh_ms = time_ms(lambda r=0: kernels.mega_path(tabs, 11 + r, 1), 10)
    mesh_plain_ms = a_big["plain_s"] * 1e3
    log(f"timing (big mesh {MESH_W}x{MESH_H}, 1 spp): kernel {mesh_ms:.3f} "
        f"ms, plain {mesh_plain_ms:.1f} ms [{card}]")

    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")
    log(json.dumps({"kernels": [
        {"name": "mega_path", "route": "cuda",
         "source": "rene_tpu_torch/csrc/mega_path.cu",
         "replaces": "rene_tpu/integrators/pallas_path.py:4266",
         "launches": l_k1a["mega_path"],
         "max_abs_err": max(a_mat["max_abs"], a_main["max_abs"]),
         "ms": k1a_ms, "plain_ms": k1a_plain_ms},
        {"name": "mega_path_mesh", "route": "cuda",
         "source": "rene_tpu_torch/csrc/mega_path.cu",
         "replaces": "rene_tpu/integrators/pallas_path.py:2255 :2440 "
                     ":2636 :2663",
         "launches": l_mesh["mega_path_mesh"],
         "max_abs_err": max(a["max_abs"] for a in a_mesh + [a_big]),
         "ms": mesh_ms, "plain_ms": mesh_plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
