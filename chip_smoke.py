#!/usr/bin/env python3
"""GPU smoke run of rene_tpu_torch, the PyTorch/CUDA port of rene-tpu.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits nonzero without printing a result
when either is missing or any check fails. Phases:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. the build of csrc/mega_path.cu with nvcc (timed, ptxas usage shown);
3. kernel vs plain version on the card: an inline 128x64 scene with all
   8 material types, emissive sphere and quad, a distant light and the
   tent filter at maxdepth 16, 4 spp, the same seed for both;
4. the main path: `python -m rene_tpu_torch.cli` on an inline Cornell box
   at 1024x1024 and 64 spp, with normal and albedo AOVs;
5. the main path's kernel launch against the plain version: the 64-spp
   chunk over 1024x1024 (128 TPU-sized tiles of lanes) with the CLI's
   chunk seed, held to the same limits as phase 3; then timing of the
   kernel and the plain version at the main path's shape (a 1-spp chunk).

The per-pixel rule and the card's limits are rene_tpu_torch.checks'.

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


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from rene_tpu_torch import checks, cli, kernels, scenes
    from rene_tpu_torch.integrators import mega_path as M
    from rene_tpu_torch.utils.film import read_png

    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda", 0)

    # 1. the card
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.time()
    so = kernels.build(verbose=True)
    log(f"build: {time.time() - t0:.1f} s -> {os.path.relpath(so, ROOT)}")

    # 3. kernel vs plain on the card
    tabs = tables_for(
        write_scene("materials", scenes.materials_scene(128, 64)), dev)
    seed, spp = 1234567, 4
    out_k = kernels.mega_path(tabs, seed, spp)
    torch.cuda.synchronize()
    out_p = M.path_lanes_ref(tabs, seed, spp)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out_k).all()):
        raise RuntimeError("kernel output is not finite")
    a_mat = checks.agreement(out_k, out_p)
    log("kernel vs plain (materials 128x64, 4 spp): " + json.dumps(a_mat))
    checks.check_card(a_mat, "materials 128x64 x 4 spp")

    # 4. the main path through the CLI
    scene_path = write_scene("cornell", scenes.cornell_box(1024, 1024))
    png = os.path.join(OUT_DIR, "cornell.png")
    npng = os.path.join(OUT_DIR, "cornell_normal.png")
    apng = os.path.join(OUT_DIR, "cornell_albedo.png")
    for p in (png, npng, apng):
        if os.path.exists(p):
            os.unlink(p)
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record)

    grab = Grab()
    logging.getLogger("rene_tpu_torch").addHandler(grab)
    kernels.mega_path.launches = 0
    t0 = time.time()
    rc = cli.main([scene_path, "--spp", str(MAIN_SPP), "--seed",
                   str(MAIN_SEED), "--output", png,
                   "--aov-normal", npng, "--aov-albedo", apng,
                   "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = kernels.mega_path.launches
    logging.getLogger("rene_tpu_torch").removeHandler(grab)
    if rc != 0:
        raise RuntimeError(f"cli returned {rc}")
    if launches <= 0:
        raise RuntimeError("the main path launched no kernel")
    wrote = [r for r in records if r.getMessage().startswith("wrote ")]
    if not wrote:
        raise RuntimeError("cli logged no result")
    mrays, render_s, rate = wrote[-1].args[1:4]
    imgs = {}
    for p in (png, npng, apng):
        img = read_png(p)
        if img.shape != (1024, 1024, 3):
            raise RuntimeError(f"{p}: shape {img.shape}")
        imgs[os.path.basename(p)] = float(img.mean())
    if not imgs["cornell.png"] > 0.0:
        raise RuntimeError("the rendered image is black")
    log(f"main path (cornell 1024x1024, {MAIN_SPP} spp): {launches} launches, "
        f"{mrays:.1f} Mrays, render {render_s:.3f} s, {rate:.1f} Mrays/s, "
        f"cli wall {wall:.3f} s, png means {json.dumps(imgs)}")

    # 5. the main path's launch against the plain version: the render's
    # one chunk (seed drawn as render.py draws it), over all 1024x1024 lanes
    tabs = tables_for(scene_path, dev)
    chunk_seed = int(np.random.default_rng(MAIN_SEED).integers(
        0, 2 ** 31, dtype=np.int32))
    out_k = kernels.mega_path(tabs, chunk_seed, MAIN_SPP)
    torch.cuda.synchronize()
    t0 = time.time()
    out_p = M.path_lanes_ref(tabs, chunk_seed, MAIN_SPP)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    if not bool(torch.isfinite(out_k).all()):
        raise RuntimeError("kernel output is not finite")
    a_main = checks.agreement(out_k, out_p)
    log(f"kernel vs plain (cornell 1024x1024, {MAIN_SPP} spp, seed "
        f"{chunk_seed}, plain {plain_s:.1f} s): " + json.dumps(a_main))
    checks.check_card(a_main, f"cornell 1024x1024 x {MAIN_SPP} spp")
    del out_k, out_p

    # timing at the main path's shape: one 1-spp chunk over 1024x1024
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

    kernel_ms = time_ms(lambda r=0: kernels.mega_path(tabs, 11 + r, 1), 20)
    plain_ms = time_ms(lambda r=0: M.path_lanes_ref(tabs, 11 + r, 1), 2)
    log(f"timing (cornell 1024x1024, 1 spp): kernel {kernel_ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms [{card}]")

    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")
    log(json.dumps({"kernels": [{
        "name": "mega_path", "route": "cuda",
        "source": "rene_tpu_torch/csrc/mega_path.cu",
        "replaces": "rene_tpu/integrators/pallas_path.py:4266",
        "launches": launches,
        "max_abs_err": max(a_mat["max_abs"], a_main["max_abs"]),
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
