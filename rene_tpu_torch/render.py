"""Render loop of the port: chunk loop, film average, y-flip, checkpoints.

Counterpart of rene_tpu/render.py `render` (:131) with `_render_pallas`
(:316-408), its XLA branch (:210-299) and `warm_cache` (:85), for three
engines under JAX's names, all driven by the one `render_loop`:

* "pallas": the megakernel (integrators/mega_path.py), its path body or,
  for `Integrator "volpath"`, its volpath body (integrators/volpath.py).
  Chunk seeds come from the same `np.random.default_rng(seed).integers(
  0, 2**31, dtype=np.int32)` sequence with the same chunk sizes, so a
  render here is draw for draw the JAX `render(engine="pallas")` run with
  the megakernel's interpret-mode stream.
* "wave": the wavefront engine (integrators/wave.py), path or volpath,
  one wave of spw samples per chunk, the film summed on the device across
  waves and read back once, as the JAX wave runner's `run_dev` does.
* "xla": the XLA engine (`make_xla_fn`: integrators/path.py and the XLA
  half of integrators/volpath.py, plain PyTorch on the device), which
  renders every scene the reference's XLA engine renders. It goes over
  the film in tiles of `tile_rays` lanes (at most XLA_BVH_TILE where the
  main accelerator is a BVH), chunks of LOG_EVERY samples (4 with a BVH,
  as the reference's, whose chunk seeds they keep),
  and draws its chunk seeds as `integers(0, 2**32, dtype=np.uint32)`, as
  the reference does. It takes no `Sampler "sobol"`: the reference's
  XLA integrators draw from the independent PCG32si stream alone.

The two kernel engines take the scene's sampler, `Sampler "sobol"` (the
kernels' Sobol draws) or the independent one.

"auto" takes the megakernel where `pack.slice_supported` accepts the
scene, for volpath too, and the XLA engine where it refuses it (the
reason is logged at INFO), as the reference's auto falls back to its XLA
engine. The reference's policy of sending deep scenes past 512
triangles to the wave engine (`_wave_default` :33) rests on TPU timings
and is not carried over (ROADMAP). "pallas" and "wave" raise on a scene
the kernels refuse, as the reference's do. A failed wave render raises;
the JAX fallback from the wave engine to the megakernel (:193-208) is
not carried over.

The film's sums stay on the device. A `checkpoint` or `want_var` render
runs chunk by chunk (the wave's on-device sum across waves is off, as at
:358-360): utils/checkpoint.py snapshots the sums on the host after every
chunk, and `want_var` keeps the per-chunk sums of squares that `varmean`
is made from. A resumed render adds, in the
same float32 order, exactly what an unbroken one adds, whatever the
runner: the loop counts the chunk seeds it has drawn.

Multi-device renders (parallel/shard.py) run the same loop in every rank
(`run_chunks`, the loop up to the divide, on a seed-shifted runner or on
one that renders a share of the pixels, `run.pixels`), reduce the sums
and make the film with `film_result`, as a single-device render makes
it.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import kernels
from .integrators.mega_path import make_mega_batch_fn
from .integrators.wave import make_wave_fn, pixel_sums
from .scene import build_device_scene
from .scene.device import to_torch
from .scene import pack as P
from .utils.checkpoint import (SUMS, load_checkpoint, save_checkpoint,
                               scene_fingerprint)
from .utils.film import rays_to_image

log = logging.getLogger("rene_tpu_torch.render")

DEFAULT_SPP = 5000  # rene_tpu/render.py:29
LOG_EVERY = 100     # rene_tpu/render.py:30
ENGINES = ("auto", "pallas", "wave", "xla")


# the XLA engine's largest tile of lanes where the main accelerator is a
# BVH, which bounds the walk's per-lane stacks (MAX_DEPTH_STACK int64 a
# lane: 84 MB at 2^18). The reference caps it at 2^14 (:218) to keep a
# TPU call under its watchdog, which a card does not have; the tile does
# not change the image (each pixel's stream is its own, whatever its
# tile), and on the card 2^14 ran the forced-BVH mesh of chip_smoke.py
# phase 28 1.58x slower than one tile of 32768 lanes (PERF.md section 5)
XLA_BVH_TILE = 1 << 18


def _runner(engine: str, buffers_np=None, config=None) -> str:
    """The runner an engine resolves to: `megakernel`, `wave` or `xla`.
    "auto" resolves to `xla` for a scene (given) that the kernels refuse
    (`pack.slice_supported`), logging the refusal."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r}: one of {ENGINES}")
    if engine in ("wave", "xla"):
        return engine
    if engine == "auto" and buffers_np is not None:
        try:
            P.slice_supported(buffers_np, config)
        except NotImplementedError as e:
            log.info("engine auto: the kernels refuse the scene (%s); the "
                     "XLA engine renders it", e)
            return "xla"
    return "megakernel"


def runner_libraries(buffers_np, config, engine: str = "auto"):
    """The libraries (kernels.VARIANTS) that the scene's runner launches:
    the megakernel's instance, or K2's and K3's (K4 lives in K3's); none
    for the XLA engine."""
    runner = _runner(engine, buffers_np, config)
    if runner == "xla":
        return []
    tables = P.pack_tables(buffers_np, config)
    flags = {"volpath": tables.volpath, "has_accel": tables.has_accel,
             "sobol": tables.sobol}
    if runner == "wave":
        return sorted({kernels.library(kernels.variant(flags, "wave_path")),
                       "wave_path"})
    return [kernels.library(kernels.variant(flags))]


def warm_cache(scene, engine: str = "auto", device="cuda") -> int:
    """Build with nvcc the libraries that the scene's runner launches,
    rendering nothing; returns their count (0 on the CPU, which runs the
    plain versions, and for the XLA engine, which has none). A later
    render finds them built."""
    buffers_np, config = build_device_scene(scene)
    names = runner_libraries(buffers_np, config, engine)
    if torch.device(device).type != "cuda" or not names:
        return 0
    for name, so in kernels.build(names=names).items():
        log.info("library %s: %s", name, so)
    return len(names)


def make_xla_fn(buffers_np, config, device, use_bvh: Optional[bool] = None,
                tile_rays: int = 1 << 18, pixels=None):
    """The XLA engine's runner for `render_loop` (rene_tpu/render.py:
    210-299): `run(seed, chunk)` renders `chunk` samples of every pixel
    (or of the pixels [lo, hi) of `pixels`, `run.pixels`, a tiles-mode
    rank's share) through path.render_batch (volpath.render_batch for
    `Integrator "volpath"`) in tiles of `tile_rays` lanes, and returns
    the per-pixel (N, 3) sums on `device` and the ray count. A pixel's
    samples depend on the pixel and the seed alone, whatever its tile.
    `use_bvh` True forces the BVH walk as the main accelerator
    (ops/accel.py; None and False leave the choice to the triangle
    count). run.chunk_hint is LOG_EVERY, or 4 with a BVH; its chunk seeds
    are uint32 (`run.seed_dtype`)."""
    from .integrators import path, volpath
    from .ops.accel import make_accel
    from .ops.bvh import BVH

    device = torch.device(device)
    accel = make_accel(buffers_np, config, device,
                       force="bvh" if use_bvh else None)
    batch = (volpath.render_batch if config.integrator == "volpath"
             else path.render_batch)
    bvh = isinstance(accel.main, BVH)
    if bvh:
        tile_rays = min(tile_rays, XLA_BVH_TILE)
    buffers = to_torch(buffers_np, device)
    w, h = config.film.xresolution, config.film.yresolution
    p_lo, p_hi = pixels or (0, w * h)
    pix = torch.arange(p_lo, p_hi, device=device)
    px, py = pix % w, pix // w
    tiles = [(lo, min(lo + tile_rays, pix.numel()))
             for lo in range(0, pix.numel(), tile_rays)]

    def run(seed: int, chunk: int):
        outs = [batch(buffers, config, px[lo:hi], py[lo:hi], seed, chunk,
                      accel=accel) for lo, hi in tiles]
        sums = {k: torch.cat([o[k] for o in outs]) for k in SUMS}
        sums["rays"] = sum(float(o["rays"]) for o in outs)
        run.iterations += sum(o["iterations"] for o in outs)
        return sums

    run.chunk_hint = 4 if bvh else LOG_EVERY
    run.spp_mult = 1
    run.seed_dtype = np.uint32
    run.tiles = len(tiles)
    run.iterations = 0      # bounce-loop iterations over all tiles so far
    run.pixels = (p_lo, p_hi)
    run.bvh = bvh
    return run


def render(scene, spp: int = DEFAULT_SPP, seed: int = 0, device="cuda",
           engine: str = "auto", checkpoint: Optional[str] = None,
           resume: bool = False,
           progress: Optional[Callable[[int, int, float], None]] = None,
           want_var: bool = False, use_bvh: Optional[bool] = None,
           tile_rays: int = 1 << 18):
    """Render a FlatScene on `device` with `engine` (ENGINES); returns a
    dict of (H, W, 3) float32 images (color, normal, albedo, all
    averaged; with `want_var` also `varmean`, the per-pixel variance of
    the color mean from the spread of the per-chunk means), `total_rays`
    (of the chunks this call ran), `wall_time` (seconds, ending in a
    device synchronize), `launches` (CUDA kernel launches of the kernel
    engines, 0 on the CPU and for the XLA engine), `engine` (`pallas`,
    `wave` or `xla`) and for the XLA engine `iterations` (its bounce
    loop's, summed over tiles and chunks).

    `checkpoint`: a snapshot file written after every chunk (after
    `progress(done, spp, ms)` is called); `resume` starts from it where
    its fingerprint matches, and from 0 with a warning where not.
    `use_bvh` and `tile_rays` are the XLA engine's (`make_xla_fn`)."""
    device = torch.device(device)
    buffers_np, config = build_device_scene(scene)
    runner = _runner(engine, buffers_np, config)
    if runner == "wave":
        run = make_wave_fn(buffers_np, config, device, spp_hint=spp)
    elif runner == "xla":
        run = make_xla_fn(buffers_np, config, device, use_bvh, tile_rays)
    else:
        run = make_mega_batch_fn(buffers_np, config, device, spp_hint=spp)
    fingerprint = (scene_fingerprint(buffers_np, config, seed, runner,
                                     want_var) if checkpoint else "")
    log.info("engine: %s", runner)
    launches_before = sum(kernels.launches.values())
    out = render_loop(run, config, spp, seed, device, checkpoint, resume,
                      progress, fingerprint, want_var)
    out["launches"] = sum(kernels.launches.values()) - launches_before
    out["engine"] = {"wave": "wave", "xla": "xla"}.get(runner, "pallas")
    if runner == "xla":
        out["iterations"] = run.iterations
        log.info("xla engine: %d loop iterations over %d tile(s) a chunk, "
                 "%.3f s", run.iterations, run.tiles, out["wall_time"])
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def render_loop(run, config, spp, seed, device, checkpoint=None,
                resume=False, progress=None, fingerprint="", want_var=False):
    """The chunk loop over a runner (`run(seed, chunk)` -> per-pixel sums
    over chunk * run.spp_mult samples and `rays`; `run.chunk_hint`,
    `run.spp_mult`, optionally `run.seed_dtype` (int32 by default) and
    `run.pixels`, and for a wave `run.run_dev`), as
    rene_tpu/render.py:316 `_render_pallas` drives one: the same chunk
    seeds and sizes, the same film and `varmean`."""
    device = torch.device(device)
    c = run_chunks(run, config, spp, seed, device, checkpoint, resume,
                   progress, fingerprint, want_var)
    host = {k: _host(v) for k, v in c.accum.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    result = film_result(config, host,
                         None if c.sq_sum is None else _host(c.sq_sum),
                         c.done, c.seeds)
    result.update(total_rays=c.total_rays, wall_time=time.time() - c.t_start)
    return result


@dataclasses.dataclass
class Chunks:
    """What `run_chunks` hands back before the divide: the per-pixel sums
    on the device (`accum`, SUMS, (npix, 3) each), the sums of squares
    of the per-chunk means (`sq_sum`, want_var only), the samples per
    pixel done, the chunk seeds drawn, the rays of the chunks summed and
    the loop's start time."""
    accum: dict
    sq_sum: Optional[torch.Tensor]
    done: int
    seeds: int
    total_rays: float
    t_start: float


def run_chunks(run, config, spp, seed, device, checkpoint=None,
               resume=False, progress=None, fingerprint="",
               want_var=False) -> Chunks:
    """The chunk loop of `render_loop`, up to the divide. A runner with
    `run.pixels` = (lo, hi) renders those pixels alone: its sums go into
    rows [lo, hi) of the film's, the others stay 0."""
    device = torch.device(device)
    w, h = config.film.xresolution, config.film.yresolution
    lo, hi = getattr(run, "pixels", None) or (0, w * h)
    max_chunk = min(LOG_EVERY, run.chunk_hint)
    mult = run.spp_mult
    if want_var:    # two chunks at least, so that their means spread
        max_chunk = max(1, min(max_chunk, spp // (2 * mult)))
    accum = {k: torch.zeros((w * h, 3), dtype=torch.float32, device=device)
             for k in SUMS}
    sq_sum = (torch.zeros((w * h, 3), dtype=torch.float32, device=device)
              if want_var else None)
    done = seeds = 0
    if checkpoint and resume:
        snap = load_checkpoint(checkpoint, fingerprint)
        if snap is not None:
            accum = {k: torch.from_numpy(v).to(device)
                     for k, v in snap["accum"].items()}
            if want_var:
                sq_sum = torch.from_numpy(snap["sq_sum"]).to(device)
            done, seeds = snap["samples_done"], snap["seeds"]
            log.info("resumed from %s at sample %d (%d chunks)", checkpoint,
                     done, seeds)
    # the chunk seeds: int32 below 2^31 for the kernels, uint32 for the
    # XLA engine (run.seed_dtype), as the reference's two runners draw them
    seed_dtype = np.dtype(getattr(run, "seed_dtype", np.int32))
    seed_end = int(np.iinfo(seed_dtype).max) + 1
    host_rng = np.random.default_rng(seed)
    for _ in range(seeds):      # the seeds of the chunks already summed
        host_rng.integers(0, seed_end, dtype=seed_dtype)
    # a wave's on-device sum across waves gives no per-chunk sums, which a
    # checkpoint and the sums of squares need
    dev_accum = (None if checkpoint or want_var
                 else getattr(run, "run_dev", None))
    acc = None
    total_rays = 0.0
    t_start = t_batch = time.time()
    while done < spp:
        # a packed runner may overshoot spp by < mult; the average divides
        # by the samples delivered
        chunk = min(max_chunk, -(-(spp - done) // mult))
        chunk_seed = int(host_rng.integers(0, seed_end, dtype=seed_dtype))
        seeds += 1
        if dev_accum is not None:
            acc = dev_accum(chunk_seed, chunk, acc)
            float(acc[1])   # a sync per wave keeps the chunk times honest
        else:
            out = run(chunk_seed, chunk)    # a wave's sums come as numpy
            sums = {k: torch.as_tensor(out[k], device=device) for k in SUMS}
            for k in SUMS:
                accum[k][lo:hi] += sums[k]
            if sq_sum is not None:
                # a divisor on the device: torch divides a CUDA tensor by a
                # host scalar as a product with its reciprocal, which may
                # round off numpy's quotient by one ulp
                n = torch.tensor(float(chunk * mult), device=device)
                xm = sums["radiance"] / n
                sq_sum[lo:hi] += n * xm * xm
            total_rays += float(out["rays"])
        done += chunk * mult
        dt = (time.time() - t_batch) * 1000.0
        log.info("Samples: %d/%d (%.0f ms)", done, spp, dt)
        t_batch = time.time()
        if progress:
            progress(done, spp, dt)
        if checkpoint:
            save_checkpoint(
                checkpoint, {k: _host(v) for k, v in accum.items()}, done,
                fingerprint, seeds, None if sq_sum is None else _host(sq_sum))
    if acc is not None:     # a wave's device pair; the sums are 0 here
        for k, v in pixel_sums(acc[0]).items():
            accum[k][lo:hi] += v
        total_rays += float(acc[1])
    return Chunks(accum, sq_sum, done, seeds, total_rays, t_start)


def film_result(config, host, sq_sum, done, chunks) -> dict:
    """The film from per-pixel host sums (`host`, SUMS) over `done`
    samples per pixel: the averaged, y-flipped (H, W, 3) color, normal
    and albedo, and with `sq_sum` (the sums of squares of `chunks`
    per-chunk means) the `varmean` image."""
    w, h = config.film.xresolution, config.film.yresolution
    n = max(done, 1)
    result = {k: rays_to_image(host[s] / n, w, h)
              for k, s in (("color", "radiance"), ("normal", "normal"),
                           ("albedo", "albedo"))}
    result["config"] = config
    if sq_sum is not None:
        result["varmean"] = rays_to_image(
            _var_of_mean(host["radiance"], sq_sum, done, chunks), w, h)
    return result


def _var_of_mean(sum_x, sq_sum, n_total, n_chunks):
    """Per-pixel variance of the color mean from the per-chunk means
    (rene_tpu/render.py:301), in float32: sum_x the per-sample radiance
    sum, sq_sum the sum over chunks of n_i * mean_i^2; Var[mean] ~=
    (sq_sum - n mean^2) / ((k - 1) n). One chunk gives no estimate: +inf,
    which the blend reads as "take the denoiser"."""
    n_total = max(n_total, 1)
    mean = sum_x / n_total
    if n_chunks < 2:
        return np.full_like(sum_x, np.inf)
    spread = np.maximum(sq_sum - n_total * mean * mean, 0.0)
    return spread / ((n_chunks - 1) * n_total)
