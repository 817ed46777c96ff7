"""Command line of the port: a pbrt-v3 scene in, a PNG (and AOVs) out.

    python -m rene_tpu_torch.cli scene.pbrt --spp N --seed S \
        --output out.png [--aov-normal P] [--aov-albedo P] [--device cuda|cpu]
        [--engine auto|pallas|wave|xla] [--bvh auto|on|off]
        [--tile-rays N] [--sampler auto|sobol|independent]
        [--denoiser none|atrous|cnn [--unet-weights W]]
        [--checkpoint C [--resume]] [--color-space linear|srgb|srgb-lights]
        [--scene-overrides F] [--tungsten-compat] [--mf-dist D]
        [--devices N [--multichip-mode samples|tiles]]
        [--warm-cache] [--dump-module]

Counterpart of rene_tpu/cli.py:101 `main` (the path and volpath
integrators; the megakernel and wave engines under the independent or the
Sobol sampler, and the XLA engine, which renders the scenes the kernels
refuse and which `auto` picks for them). The default device is `cuda`;
the CPU runs the kernels' plain PyTorch versions and must be asked for.
`--bvh` and `--tile-rays` are the XLA engine's: `on` forces the BVH walk
as its main accelerator, and the film goes through it in tiles of that
many lanes. `--mf-dist` and an override file's `mf_dist` set RENE_MF_DIST
for the render, as the reference does; `main` gives the variable back its
value from before the call when it returns.

`--devices N` renders over N ranks (parallel/shard.py): N cards with
`--device cuda` (exit 1 when fewer are visible), N CPU processes with
`--device cpu`. `--multichip-mode samples` gives each rank its own
samples of the whole film, `tiles` each rank a share of the pixels of
the same samples. Unlike the reference's CLI, which drops some flags
under `--devices > 1`, every flag is passed on or refused: `--bvh`,
`--tile-rays`, `--denoiser` (with its variance over every rank's chunks),
`--sampler`, `--mf-dist` and the override files reach the ranks;
`--checkpoint` / `--resume` and `--engine wave --multichip-mode tiles`
are refused with a message.

`--dump-module` prints the PTX of the kernel libraries the scene's
engine launches (`render.runner_libraries`), built by nvcc from the
package's sources, as the reference prints its lowered module (and
hatoo/rene its SPIR-V); it exits 1 for a scene that the XLA engine
renders (plain PyTorch, no module of its own) and on the CPU.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rene-tpu-torch",
        description="pbrt-v3 path tracer on an NVIDIA GPU (PyTorch + CUDA)")
    p.add_argument("scene", help="pbrt scene file")
    p.add_argument("--spp", type=int, default=None,
                   help="samples per pixel (default: 5000, like rene_tpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", help="override the Film filename")
    p.add_argument("--aov-normal", metavar="PATH",
                   help="write the normal AOV image")
    p.add_argument("--aov-albedo", metavar="PATH",
                   help="write the albedo AOV image")
    p.add_argument("--denoiser", choices=["none", "atrous", "cnn"],
                   default="none",
                   help="AOV-guided denoiser, blended with the raw image "
                        "by the render's per-pixel variance")
    p.add_argument("--unet-weights", metavar="PATH",
                   help="U-Net weights for --denoiser cnn, as "
                        "rene_tpu.models.train_denoiser writes them")
    p.add_argument("--checkpoint", metavar="PATH",
                   help="film checkpoint file (saved after every chunk)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if present")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the CUDA kernels (default); cpu: their "
                        "plain PyTorch versions")
    p.add_argument("--engine", choices=["auto", "pallas", "wave", "xla"],
                   default="auto",
                   help="pallas: the megakernel; wave: the wavefront "
                        "engine; xla: the XLA engine (plain PyTorch on "
                        "the device); auto: the megakernel, or the XLA "
                        "engine for a scene the kernels refuse")
    p.add_argument("--bvh", choices=["auto", "on", "off"], default="auto",
                   help="the XLA engine's accelerator: on forces the BVH "
                        "walk; auto and off take the matrix-product "
                        "intersector up to 4096 triangles")
    p.add_argument("--tile-rays", type=int, default=1 << 18,
                   help="lanes per call of the XLA engine (at most "
                        "262144 with a BVH)")
    p.add_argument("--sampler", choices=["auto", "sobol", "independent"],
                   default="auto",
                   help="override the scene's Sampler directive (auto "
                        "honors it; sobol = padded Owen-scrambled "
                        "(0,2)-sequence draws in both engines)")
    p.add_argument("--color-space", choices=["linear", "srgb",
                                             "srgb-lights"],
                   default="linear",
                   help="rgb value interpretation; srgb-lights matches the "
                        "shipped Tungsten goldens")
    p.add_argument("--scene-overrides", metavar="FILE",
                   help="JSON instance/material override file applied "
                        "after scene flattening (scene/overrides.py)")
    p.add_argument("--tungsten-compat", action="store_true",
                   help="apply the shipped Tungsten-golden calibration "
                        "for this scene (docs/overrides/<scene>_tungsten*"
                        ".json); a file marked requires_denoiser is "
                        "applied only with --denoiser")
    p.add_argument("--mf-dist", choices=["auto", "ggx", "beckmann"],
                   default="auto",
                   help="microfacet distribution for all rough "
                        "conductors/dielectrics (auto = ggx unless an "
                        "override file selects otherwise)")
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="render over N ranks: N cards (--device cuda) or "
                        "N CPU processes (--device cpu), the films summed "
                        "with one all_reduce")
    p.add_argument("--multichip-mode", choices=["samples", "tiles"],
                   default="samples",
                   help="samples: each rank traces the whole film at its "
                        "own samples; tiles: the ranks split the film's "
                        "pixels (the image equals one device's)")
    p.add_argument("--warm-cache", action="store_true",
                   help="build the scene's kernel libraries with nvcc and "
                        "exit without rendering")
    p.add_argument("--dump-module", action="store_true",
                   help="print the PTX of the scene's kernel libraries "
                        "and exit (the reference dumps its lowered "
                        "module)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    before = os.environ.get("RENE_MF_DIST")
    try:
        return _main(build_parser().parse_args(argv))
    finally:
        if before is None:
            os.environ.pop("RENE_MF_DIST", None)
        else:
            os.environ["RENE_MF_DIST"] = before


def _overrides_file(args, log):
    """The override file to apply: --scene-overrides, else with
    --tungsten-compat the shipped calibration, skipped for a raw render
    where it declares `requires_denoiser` (rene_tpu/cli.py:122-151)."""
    if args.scene_overrides or not args.tungsten_compat:
        return args.scene_overrides
    from .scene.overrides import find_tungsten_overrides
    ov_file = find_tungsten_overrides(args.scene)
    if ov_file is None:
        log.warning("--tungsten-compat: no shipped calibration for this "
                    "scene (docs/overrides/); rendering as-is")
    elif args.denoiser == "none":
        try:
            with open(ov_file) as f:
                spec = json.load(f)
        except (OSError, ValueError):
            spec = {}
        if spec.get("requires_denoiser"):
            log.info("--tungsten-compat: %s is calibrated for denoised "
                     "output only; skipping for this raw render (pass "
                     "--denoiser atrous/cnn to apply)",
                     os.path.basename(ov_file))
            return None
    return ov_file


def _refused(args):
    """Why the flags cannot go together, or None."""
    if args.devices < 1:
        return f"--devices {args.devices}: at least 1"
    if args.devices > 1 and (args.checkpoint or args.resume):
        return ("--checkpoint / --resume: a render over --devices > 1 "
                "keeps no checkpoint; render on one device to checkpoint")
    if args.devices > 1 and args.engine == "wave" \
            and args.multichip_mode == "tiles":
        return ("--engine wave renders --multichip-mode samples only; "
                "tiles mode is the megakernel's and the XLA engine's")
    return None


def _dump_module(scene, args, log) -> int:
    """Print the PTX of the libraries the scene's engine launches."""
    from . import kernels
    from .render import runner_libraries
    from .scene import build_device_scene
    if args.device != "cuda":
        log.error("--dump-module: on the CPU the kernels run as their plain "
                  "PyTorch versions, which have no module; pass --device "
                  "cuda")
        return 1
    buffers_np, config = build_device_scene(scene)
    names = runner_libraries(buffers_np, config, args.engine)
    if not names:
        log.error("--dump-module: the XLA engine renders this scene in "
                  "plain PyTorch, with no module of its own")
        return 1
    for name in names:
        log.info("PTX of %s (%s)", name, kernels.BUILDS[name][0])
        sys.stdout.write(kernels.ptx(name))
    sys.stdout.flush()
    return 0


def _main(args) -> int:
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s [%(name)s] %(message)s")
    log = logging.getLogger("rene_tpu_torch")
    refused = _refused(args)
    if refused:
        log.error(refused)
        return 1

    t0 = time.time()
    from .pbrt import ParseError
    from .scene import load_scene
    try:
        scene = load_scene(args.scene, color_space=args.color_space)
    except ParseError as e:
        print(e.render(args.scene), file=sys.stderr)
        return 1
    if args.sampler != "auto":
        scene.sampler = args.sampler
    if args.mf_dist != "auto":
        os.environ["RENE_MF_DIST"] = args.mf_dist
    ov_file = _overrides_file(args, log)
    if ov_file:
        from .scene.overrides import apply_overrides
        apply_overrides(scene, ov_file)
        if args.mf_dist != "auto":  # the flag beats the file
            os.environ["RENE_MF_DIST"] = args.mf_dist
        log.info("applied scene overrides from %s", ov_file)
    log.info("scene compiled in %.2fs", time.time() - t0)

    if args.dump_module:
        return _dump_module(scene, args, log)

    if args.warm_cache:
        from .render import warm_cache
        t = time.time()
        n = warm_cache(scene, engine=args.engine, device=args.device)
        log.info("warmed %d kernel librar%s in %.1fs", n,
                 "y" if n == 1 else "ies", time.time() - t)
        return 0

    from .render import DEFAULT_SPP, render
    from .utils.film import save_png, to_aov8, to_aov_normal8, to_rgb8
    spp = args.spp if args.spp is not None else DEFAULT_SPP
    use_bvh = {"auto": None, "on": True, "off": False}[args.bvh]
    if args.devices > 1:
        import torch
        from .parallel.shard import make_mesh, render_multichip
        if args.device == "cuda":
            present = torch.cuda.device_count()
            if present < args.devices:
                log.error("--devices %d requested but only %d present",
                          args.devices, present)
                return 1
            mesh = make_mesh([f"cuda:{i}" for i in range(args.devices)])
        else:
            mesh = make_mesh(["cpu"] * args.devices)
        out = render_multichip(scene, spp=spp, seed=args.seed, mesh=mesh,
                               tile_rays=args.tile_rays,
                               mode=args.multichip_mode,
                               engine=args.engine, use_bvh=use_bvh,
                               want_var=args.denoiser != "none")
    else:
        out = render(scene, spp=spp, seed=args.seed, device=args.device,
                     engine=args.engine, checkpoint=args.checkpoint,
                     resume=args.resume, want_var=args.denoiser != "none",
                     use_bvh=use_bvh, tile_rays=args.tile_rays)
    color = out["color"]
    if args.denoiser != "none":
        from .models.denoise import UNetDenoiser, denoise
        unet = None
        if args.denoiser == "cnn" and args.unet_weights:
            unet = UNetDenoiser.load(args.unet_weights, device=args.device)
        t = time.time()
        color = denoise(color, out["normal"], out["albedo"],
                        method=args.denoiser, unet=unet,
                        varmean=out["varmean"], device=args.device)
        log.info("denoise (%s) in %.2fs", args.denoiser, time.time() - t)
    written = save_png(args.output or scene.film.filename, to_rgb8(color))
    log.info("wrote %s (%.1f Mrays in %.1fs, %.1f Mrays/s, %d launches, "
             "%s engine)", written, out["total_rays"] / 1e6,
             out["wall_time"],
             out["total_rays"] / max(out["wall_time"], 1e-9) / 1e6,
             out["launches"], out["engine"])
    if args.aov_normal:
        save_png(args.aov_normal, to_aov_normal8(out["normal"]))
    if args.aov_albedo:
        save_png(args.aov_albedo, to_aov8(out["albedo"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
