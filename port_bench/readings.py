"""The readings a cell's limits are set from, many seeds in one process.

    python3 port_bench/readings.py --workload cornell.final \
        --seeds 11 12 13 [--images 4] [--out readings.jsonl]

Builds the program as a run does (harness.Program) once, then for each
seed renders images 0 .. images - 1 of that seed's run and checks their
pixels (the check file's `pixels_per_image`, drawn as a run draws them)
against the reference, and the control against the same reference: the
reference itself with its per-chunk sums and film in bfloat16, the
precision below the configuration's float32 that a later change to the
film would be tempted by. Prints one JSON line per seed: the program's
numbers (sound readings), the control's (upper readings) and the
reference's seconds. The benchmark's runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT


def main(argv) -> int:
    import torch
    from port_bench import check, harness
    from port_bench.reference import render as R

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--images", type=int, default=check.IMAGES,
                    help="images a seed")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    n_pix = int(cell.check["pixels_per_image"])
    device = torch.device("cuda:0")
    out = open(args.out, "a") if args.out else None
    with tempfile.TemporaryDirectory(prefix="port_bench_") as d:
        path = os.path.join(d, "scene.pbrt")
        with open(path, "w") as f:
            f.write(harness.scene_text(cell.config))
        prog = harness.Program(cell, path, device)
        prog.image(harness.image_seed(0, -1))
        tabs = R.load_tables(path, device)
        npix = prog.width * prog.height
        for seed in args.seeds:
            idx = list(range(args.images))
            images = check.images_for(seed, idx, npix, n_pix)
            kept = [prog.pixels(prog.image(s), pix) for s, pix in images]
            t = time.perf_counter()
            ref, ctl = R.film_pixels(
                tabs, prog.spp, images,
                film_dtypes=(torch.float32, torch.bfloat16))
            ref_s = time.perf_counter() - t
            ctl_kept = [np.concatenate([ctl[k][i] for k in
                                        ("color", "normal", "albedo")], 1)
                        for i in range(len(idx))]
            line = {"workload": cell.name, "seed": seed,
                    "images": args.images,
                    "pixels": n_pix, "ref_s": ref_s,
                    "program": check.compare(kept, ref),
                    "control": check.compare(ctl_kept, ref)}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
