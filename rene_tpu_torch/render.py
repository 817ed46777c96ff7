"""Render loop of the port: chunk loop, film average, y-flip.

Counterpart of rene_tpu/render.py `render` (:131) with `_render_pallas`
(:316-408), for two engines under JAX's names:

Both engines take the scene's sampler, `Sampler "sobol"` (the kernels'
Sobol draws) or the independent one.

* "pallas" (and "auto"): the megakernel (integrators/mega_path.py), its
  path body or, for `Integrator "volpath"`, its volpath body
  (integrators/volpath.py).
  Chunk seeds come from the same `np.random.default_rng(seed).integers(
  0, 2**31, dtype=np.int32)` sequence with the same chunk sizes, so a
  render here is draw for draw the JAX `render(engine="pallas")` run with
  the megakernel's interpret-mode stream.
* "wave": the wavefront engine (integrators/wave.py), path or volpath,
  one wave of spw samples per chunk, the film summed on the device across
  waves and read back once, as the JAX wave runner's `run_dev` does.

"auto" stays on the megakernel, for volpath too: the reference's policy
(`_wave_default` :33, deep scenes past 512 triangles to the wave engine)
rests on TPU timings (ROADMAP). A failed wave render raises; the JAX
fallback from the wave engine to the megakernel (:193-208) is not
carried over. "xla" (the JAX package's XLA integrator) is not ported.
Checkpoint/resume, `want_var`, denoising and multi-device runs are not
in the port yet.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from . import kernels
from .integrators.mega_path import make_mega_batch_fn
from .integrators.wave import make_wave_fn
from .scene import build_device_scene
from .utils.film import rays_to_image

log = logging.getLogger("rene_tpu_torch.render")

DEFAULT_SPP = 5000  # rene_tpu/render.py:29
LOG_EVERY = 100     # rene_tpu/render.py:30
ENGINES = ("auto", "pallas", "wave", "xla")


def render(scene, spp: int = DEFAULT_SPP, seed: int = 0, device="cuda",
           engine: str = "auto"):
    """Render a FlatScene on `device` with `engine` (ENGINES); returns a
    dict of (H, W, 3) float32 images (color, normal, albedo, all
    averaged), `total_rays`, `wall_time` (seconds, ending in a device
    synchronize), `launches` (kernel launches, 0 on the CPU) and
    `engine`."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r}: one of {ENGINES}")
    if engine == "xla":
        raise NotImplementedError(
            "the XLA integrator is not in the port (ROADMAP Queue 1 item "
            "4: the XLA engine)")
    device = torch.device(device)
    buffers_np, config = build_device_scene(scene)
    if engine == "wave":
        run = make_wave_fn(buffers_np, config, device, spp_hint=spp)
    else:
        run = make_mega_batch_fn(buffers_np, config, device, spp_hint=spp)
    dev_accum = getattr(run, "run_dev", None)
    acc = None
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
        if dev_accum is not None:
            acc = dev_accum(chunk_seed, chunk, acc)
            float(acc[1])   # a sync per wave keeps the chunk times honest
        else:
            out = run(chunk_seed, chunk)
            for k in accum:
                accum[k] += out[k]
            total_rays += float(out["rays"])
        done += chunk * mult
        dt = (time.time() - t_batch) * 1000.0
        log.info("Samples: %d/%d (%.0f ms)", done, spp, dt)
        t_batch = time.time()
    host = {k: v.cpu().numpy() for k, v in accum.items()}
    if acc is not None:
        out = run.read_back(acc)
        for k in host:
            host[k] += out[k]
        total_rays += out["rays"]
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
        "engine": "wave" if engine == "wave" else "pallas",
    }
