"""Render loop of the port: chunk loop, film average, y-flip.

Counterpart of rene_tpu/render.py `render` (:131) with `_render_pallas`
(:316-408) for the megakernel engine. Chunk seeds come from the same
`np.random.default_rng(seed).integers(0, 2**31, dtype=np.int32)` sequence
with the same chunk sizes, so a render here is draw for draw the JAX
`render(engine="pallas")` run with the megakernel's interpret-mode
stream. Checkpoint/resume, `want_var`, denoising and multi-device runs
are not in this slice.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from . import kernels
from .integrators.mega_path import make_mega_batch_fn
from .scene import build_device_scene
from .utils.film import rays_to_image

log = logging.getLogger("rene_tpu_torch.render")

DEFAULT_SPP = 5000  # rene_tpu/render.py:29
LOG_EVERY = 100     # rene_tpu/render.py:30


def render(scene, spp: int = DEFAULT_SPP, seed: int = 0, device="cuda"):
    """Render a FlatScene on `device`; returns a dict of (H, W, 3) float32
    images (color, normal, albedo, all averaged), `total_rays`,
    `wall_time` (seconds, ending in a device synchronize) and `launches`
    (kernel launches, 0 on the CPU)."""
    device = torch.device(device)
    buffers_np, config = build_device_scene(scene)
    run = make_mega_batch_fn(buffers_np, config, device)
    w, h = config.film.xresolution, config.film.yresolution
    max_chunk = min(LOG_EVERY, run.chunk_hint)
    mult = run.spp_mult
    host_rng = np.random.default_rng(seed)
    accum = {k: torch.zeros((w * h, 3), dtype=torch.float32, device=device)
             for k in ("radiance", "normal", "albedo")}
    total_rays = 0.0
    launches_before = sum(kernels.launches.values())
    t_start = time.time()
    t_batch = time.time()
    done = 0
    while done < spp:
        chunk = min(max_chunk, -(-(spp - done) // mult))
        chunk_seed = int(host_rng.integers(0, 2 ** 31, dtype=np.int32))
        out = run(chunk_seed, chunk)
        for k in accum:
            accum[k] += out[k]
        total_rays += float(out["rays"])
        done += chunk * mult
        dt = (time.time() - t_batch) * 1000.0
        log.info("Samples: %d/%d (%.0f ms)", done, spp, dt)
        t_batch = time.time()
    host = {k: v.cpu().numpy() for k, v in accum.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {
        "color": rays_to_image(host["radiance"] / max(done, 1), w, h),
        "normal": rays_to_image(host["normal"] / max(done, 1), w, h),
        "albedo": rays_to_image(host["albedo"] / max(done, 1), w, h),
        "config": config,
        "total_rays": total_rays,
        "wall_time": time.time() - t_start,
        "launches": sum(kernels.launches.values()) - launches_before,
    }
