"""Command line of the port: a pbrt-v3 scene in, a PNG (and AOVs) out.

    python -m rene_tpu_torch.cli scene.pbrt --spp N --seed S \
        --output out.png [--aov-normal P] [--aov-albedo P] [--device cuda|cpu]
        [--engine auto|pallas|wave] [--sampler auto|sobol|independent]

Counterpart of rene_tpu/cli.py:101 `main` for the slice the port carries
(the path and volpath integrators under the independent or the Sobol
sampler; the megakernel and wave engines). The
default device is `cuda`; the CPU runs the kernels' plain PyTorch
versions and must be asked for.
"""
from __future__ import annotations

import argparse
import logging
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
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the CUDA kernels (default); cpu: their "
                        "plain PyTorch versions")
    p.add_argument("--engine", choices=["auto", "pallas", "wave", "xla"],
                   default="auto",
                   help="pallas: the megakernel; wave: the wavefront "
                        "engine; auto: the megakernel (xla is not ported)")
    p.add_argument("--sampler", choices=["auto", "sobol", "independent"],
                   default="auto",
                   help="override the scene's Sampler directive (auto "
                        "honors it; sobol = padded Owen-scrambled "
                        "(0,2)-sequence draws in both engines)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s [%(name)s] %(message)s")
    log = logging.getLogger("rene_tpu_torch")

    t0 = time.time()
    from .pbrt import ParseError
    from .scene import load_scene
    try:
        scene = load_scene(args.scene)
    except ParseError as e:
        print(e.render(args.scene), file=sys.stderr)
        return 1
    if args.sampler != "auto":
        scene.sampler = args.sampler
    log.info("scene compiled in %.2fs", time.time() - t0)

    from .render import DEFAULT_SPP, render
    from .utils.film import save_png, to_aov8, to_aov_normal8, to_rgb8
    spp = args.spp if args.spp is not None else DEFAULT_SPP
    out = render(scene, spp=spp, seed=args.seed, device=args.device,
                 engine=args.engine)
    written = save_png(args.output or scene.film.filename,
                       to_rgb8(out["color"]))
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
