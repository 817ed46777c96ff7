"""Whether a run's images are right: the films the timed window produced,
held against the benchmark's plain reference.

After the window has closed and the program's state is freed, a sample
of the window's images (IMAGES of them: the first, the last and others
drawn from the run's seed) is rendered again by the reference
(reference/render.py) at the pixels that the window kept of each
(`pixel_sample`: the check file's `pixels_per_image`, drawn from the
seed and the image's index), from the same scene text and image seeds,
on tables the reference builds itself. Three numbers, each with its
limit in the check file:

* `rad_mismatch`: the share of those pixels whose color differs from the
  reference's by more than RAD_ATOL + RAD_RTOL |ref| in some channel (a
  value that is not finite differs);
* `aov_mismatch`: the same for the normal and albedo AOVs, by AOV_ATOL +
  AOV_RTOL |ref|;
* `non_finite`: the values of those pixels that are not finite (limit
  0).

A cell compares the numbers its check file gives limits for: a number
that the control does not separate from sound runs is left out there.

A kernel and its plain version round differently (nvcc contracts
multiply-adds), so a rare lane takes the other side of a branch and then
follows another path: its pixel differs by the noise of its samples.
That, and nothing else, is what sound runs show; PERF.md gives the
readings each limit was set from.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

RAD_RTOL, RAD_ATOL = 1e-3, 1e-5
AOV_RTOL, AOV_ATOL = 1e-3, 1e-5
IMAGES = 4              # images of a run that the check renders again
# the lanes of the scene whose plain walk the roofline metrics count
COUNT_SEED, COUNT_LANES = 1, 1024


def choose_images(seed: int, n_images: int, m: int) -> List[int]:
    """Indices of the images the check reads: the first, the last and
    m - 2 others drawn from `seed`, ascending."""
    if n_images <= m:
        return list(range(n_images))
    gen = np.random.default_rng([seed % (1 << 64), 2])
    mid = gen.choice(np.arange(1, n_images - 1), m - 2, replace=False)
    return sorted({0, n_images - 1, *map(int, mid)})


def compare(prog: List[np.ndarray], ref: Dict) -> Dict[str, float]:
    """The check's numbers for the program's (P, 9) pixels of each image
    against the reference's `film_pixels` result for the same pixels."""
    p = np.concatenate(prog).astype(np.float64)
    r = np.concatenate([np.concatenate([ref[k][i] for k in
                                        ("color", "normal", "albedo")], 1)
                        for i in range(len(prog))]).astype(np.float64)
    with np.errstate(invalid="ignore"):
        d = np.abs(p - r)
        rad_ok = (d[:, :3] <= RAD_ATOL + RAD_RTOL * np.abs(r[:, :3])).all(1)
        aov_ok = (d[:, 3:] <= AOV_ATOL + AOV_RTOL * np.abs(r[:, 3:])).all(1)
    return {"rad_mismatch": float(1.0 - rad_ok.mean()),
            "aov_mismatch": float(1.0 - aov_ok.mean()),
            "non_finite": float((~np.isfinite(p)).sum())}


def images_for(seed: int, idx: List[int], npix: int, n_pix: int):
    """(image seed, pixels) of the images `idx` of a run of `seed`."""
    from .harness import image_seed, pixel_sample
    return [(image_seed(seed, i), pixel_sample(seed, i, npix, n_pix))
            for i in idx]


def judge(cell, scene_path: str, device, seed: int, win, dims,
          counting: bool = False, log=print) -> Dict:
    """The check of a run: {"correct", "numbers": {name: {"value",
    "limit"}}, "work"}; with `counting` also the plain versions' work per
    sample for the roofline metrics (`work`)."""
    from .reference import render as R
    width, height, spp = dims
    t = time.perf_counter()
    tabs = R.load_tables(scene_path, device)
    idx = choose_images(seed, win.images, IMAGES)
    images = images_for(seed, idx, width * height,
                        int(cell.check["pixels_per_image"]))
    ref = R.film_pixels(tabs, spp, images)
    values = compare([win.kept[i] for i in idx], ref)
    log(f"{cell.name}: reference over images {idx} x "
        f"{cell.check['pixels_per_image']} pixels in "
        f"{time.perf_counter() - t:.3f} s")
    limits = cell.check["limits"]
    numbers = {k: {"value": values[k], "limit": float(v)}
               for k, v in limits.items()}
    correct = all(n["value"] <= n["limit"] for n in numbers.values())
    work = None
    if counting:
        t = time.perf_counter()
        work = R.count_ops(tabs, spp, COUNT_SEED, COUNT_LANES)
        work["samples_per_image"] = float(spp) * width * height
        work["launches_per_image"] = len(R.chunk_plan(spp, work["pack"], 0))
        work["lanes_per_launch"] = width * height * work["pack"]
        log(f"{cell.name}: the plain walk's counts per sample in "
            f"{time.perf_counter() - t:.3f} s: {work}")
    return {"correct": correct, "numbers": numbers, "work": work}
