"""Multi-device renders: data parallelism over samples, or pixel tiles.

Counterpart of rene_tpu/parallel/shard.py. JAX runs one program over a
device mesh (`shard_map`) and sums the films with `psum`; here every
device of the mesh is a rank of its own, a process started with
torch.multiprocessing (`spawn`), and the films are summed with one
`all_reduce` at the end. The ranks meet through a `file://` store in a
temporary directory, so no TCP port is taken.

* `make_mesh(devices)`: the ranks' devices, one per rank (by default
  every visible card), and the backend they reduce over: `nccl` where
  every rank has a card of its own, `gloo` for CPU ranks and for ranks
  that share a card (NCCL refuses two ranks on one GPU).
* `render_multichip(scene, spp, seed, mesh, tile_rays, mode, engine)`:
  - mode "samples": every rank renders the whole film at its own chunk
    seeds, the render's chunk seeds shifted as the reference shifts them
    (`device_seed`), and the ranks' sums add up to world times the
    samples of one rank: spp rounds up to a multiple of the device count
    (times the megakernel's pack);
  - mode "tiles": every rank renders its share of the pixels
    (`pixel_shares`) at the render's own chunk seeds, so the film equals
    the single-device render of the same seed (a lane's or a pixel's
    samples depend on its id and the seed alone). The megakernel launches
    the share's lanes alone (`kernels.mega_path(..., pixels=)`); the wave
    engine renders samples mode only.
  Every rank keeps a full-film sum on its device, zero outside its pixels
  in tiles mode, so one `all_reduce(SUM)` serves both modes (x + 0 is
  exact); the sums of squares of `want_var` and the chunk counts reduce
  with them, so `varmean` is formed from every rank's chunks. Rank 0
  hands the film back. A rank that fails makes the render raise.

Each rank runs `render.run_chunks`, the single-device chunk loop, on its
own runner. The seeds and roundings of the reference, each in its own
integer width:

* XLA engine: a step of one sample, chunk seeds uint32; in samples mode
  rank i runs seed ^ (i * 0x9E3779B9 + 1) (shard.py:49), ceil(spp /
  world) steps (:238); in tiles mode spp steps at the render's seeds.
* megakernel: chunk seeds int32 below 2^31; in samples mode rank i runs
  seed + i * 0x3779B1 in int32 (:140), ceil(spp / (world * pack)) chunks
  of the pack (:285-291); tiles mode is the single-device render's loop.
* wave engine (samples only): seed + i * 1000003 in int32 for the wave's
  genesis and every K2 launch alike (pallas_wave.py:751, :778).

Not carried over: JAX's padding of a ragged tile batch with repeats of
its last pixel (:236-251), whose rays it scales away; a rank here
renders its own pixels and counts their rays exactly.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import os
import pickle
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernels
from .. import render as R
from ..integrators.mega_path import make_mega_batch_fn
from ..integrators.wave import make_wave_fn
from ..scene import build_device_scene
from ..scene import pack as P
from ..utils.checkpoint import SUMS

log = logging.getLogger("rene_tpu_torch.parallel")

MODES = ("samples", "tiles")
# the per-rank seed shifts of samples mode (rene_tpu/parallel/shard.py:49,
# :140, rene_tpu/integrators/pallas_wave.py:751)
XLA_SEED_MUL = 0x9E3779B9
MEGA_SEED_MUL = 0x3779B1
WAVE_SEED_MUL = 1000003
# how long a rank waits for the others at the store and in a collective
RANK_TIMEOUT_S = 900


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks' devices, one per rank, and the backend they reduce
    over."""
    devices: tuple
    backend: str

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over `devices` (torch devices or their names; a card named
    twice puts two ranks on it), by default every visible card. The
    backend follows from them: `nccl` where every rank has a card of its
    own, `gloo` for CPU ranks and where ranks share a card."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; name "
                               "the devices, e.g. ['cpu', 'cpu']")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        if d.type not in ("cpu", "cuda"):
            raise ValueError(f"make_mesh: device {d}: CPU or CUDA only")
        devs.append(d)
    if not devs:
        raise ValueError("make_mesh: no devices")
    kinds = {d.type for d in devs}
    if len(kinds) > 1:
        raise ValueError(f"make_mesh: {devs} mixes CPU and CUDA ranks")
    own_cards = kinds == {"cuda"} and len(set(devs)) == len(devs)
    backend = "nccl" if own_cards else "gloo"
    log.info("mesh: %d rank(s) on %s, backend %s", len(devs),
             ", ".join(map(str, devs)), backend)
    return Mesh(tuple(devs), backend)


def _int32(x: int) -> int:
    return (int(x) + (1 << 31)) % (1 << 32) - (1 << 31)


def device_seed(runner: str, seed: int, idx: int) -> int:
    """The chunk seed rank `idx` runs in samples mode for the render's
    chunk seed `seed`: for the XLA engine seed ^ (idx * 0x9E3779B9 + 1)
    in uint32, for the wave engine seed + idx * 1000003 and for the
    megakernel seed + idx * 0x3779B1, both wrapping in int32."""
    if runner == "xla":
        return int(seed) ^ ((idx * XLA_SEED_MUL + 1) & 0xFFFFFFFF)
    if runner == "wave":
        return _int32(seed + idx * WAVE_SEED_MUL)
    return _int32(seed + idx * MEGA_SEED_MUL)


def pixel_shares(npix: int, world: int) -> list:
    """The pixels [lo, hi) of each rank in tiles mode: consecutive runs of
    the film's pixels (row-major, as the lanes count them), the first
    npix % world ranks one pixel more."""
    base, extra = divmod(npix, world)
    bounds = np.cumsum([0] + [base + (r < extra) for r in range(world)])
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def _shifted(run, shift):
    """`run` with every chunk seed passed through `shift` (a wave's
    run_dev too)."""
    def shifted(seed, chunk):
        return run(shift(seed), chunk)
    shifted.__dict__.update(run.__dict__)
    if hasattr(run, "run_dev"):
        def run_dev(seed, chunk, accum=None, split=None):
            return run.run_dev(shift(seed), chunk, accum, split)
        shifted.run_dev = run_dev
    return shifted


def rank_runner(buffers_np, config, device, runner: str, spp: int,
                mode: str, rank: int, world: int, use_bvh=None,
                tile_rays: int = 1 << 18):
    """Rank `rank`'s runner for `render.run_chunks` and the samples per
    pixel it renders: its share of the pixels (tiles), or the whole film
    at seed-shifted chunk seeds (samples)."""
    w, h = config.film.xresolution, config.film.yresolution
    tiles = mode == "tiles"
    pixels = pixel_shares(w * h, world)[rank] if tiles else None
    if runner == "xla":
        run = R.make_xla_fn(buffers_np, config, device, use_bvh, tile_rays,
                            pixels=pixels)
        run.chunk_hint = 1      # one sample a step (shard.py:238-262)
    elif runner == "wave":
        if tiles:
            raise ValueError("the wave engine renders samples mode only")
        run = make_wave_fn(buffers_np, config, device, spp_hint=spp)
    else:
        run = make_mega_batch_fn(buffers_np, config, device,
                                 spp_hint=spp if tiles else -(-spp // world),
                                 pixels=pixels)
    if tiles:
        return run, spp
    mult = run.spp_mult
    return (_shifted(run, lambda s: device_seed(runner, s, rank)),
            -(-spp // (world * mult)) * mult)


def rank_chunks(buffers_np, config, device, runner: str, spp: int,
                seed: int, mode: str, rank: int, world: int,
                want_var: bool = False, use_bvh=None,
                tile_rays: int = 1 << 18):
    """Rank `rank`'s part of a render on `device`, without the other
    ranks: `render.run_chunks` over `rank_runner`. Returns the
    render.Chunks, whose sums stay on the device (the ranks of a render
    add them up), and what the runner was: its pixels and, for the XLA
    engine, whether its main accelerator is the BVH walk and its tiles of
    lanes."""
    device = torch.device(device)
    run, spp_r = rank_runner(buffers_np, config, device, runner, spp, mode,
                             rank, world, use_bvh, tile_rays)
    c = R.run_chunks(run, config, spp_r, seed, device, want_var=want_var)
    info = {"pixels": list(getattr(run, "pixels", None)
                           or (0, config.film.xresolution
                               * config.film.yresolution))}
    if runner == "xla":
        info.update(bvh=run.bvh, tiles=run.tiles)
    return c, info


@dataclasses.dataclass
class _Job:
    """What every rank is given."""
    buffers_np: dict
    config: object
    runner: str
    spp: int
    seed: int
    mode: str
    want_var: bool
    use_bvh: Optional[bool]
    tile_rays: int
    devices: tuple
    backend: str
    store: str
    out_dir: str
    threads: int
    log_level: int
    t_spawn: float      # the parent's clock when it started the ranks


def _rank_main(rank: int, job_file: str) -> None:
    """One rank: its part, the reduce, and on rank 0 the film. The job
    comes in a file, so that no rank's start waits on another's (a
    spawned process reads its arguments only once it has imported)."""
    t_entry = time.time()
    import torch.distributed as dist
    with open(job_file, "rb") as f:
        job = pickle.load(f)
    world = len(job.devices)
    torch.set_num_threads(max(1, job.threads // world))
    logging.basicConfig(level=job.log_level,
                        format=f"%(levelname)s [rank {rank}] [%(name)s] "
                               f"%(message)s")
    device = job.devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        job.backend, init_method=job.store, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
        device_id=device if job.backend == "nccl" else None)
    try:
        before = dict(kernels.launches)
        dist.barrier()
        t0 = time.time()
        c, info = rank_chunks(job.buffers_np, job.config, device, job.runner,
                              job.spp, job.seed, job.mode, rank, world,
                              job.want_var, job.use_bvh, job.tile_rays)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_rendered = time.time()
        sums = [c.accum[k] for k in SUMS]
        if c.sq_sum is not None:
            sums.append(c.sq_sum)
        flat = torch.stack(sums)
        dist.all_reduce(flat)
        # samples mode adds the ranks' samples and chunks; in tiles mode
        # every rank ran the same chunks over other pixels
        counts = torch.tensor(
            [c.total_rays] + ([c.done, c.seeds] if job.mode == "samples"
                              else [0, 0]),
            dtype=torch.float64, device=device)
        dist.all_reduce(counts)
        rays = float(counts[0])
        done, seeds = ((int(counts[1]), int(counts[2]))
                       if job.mode == "samples" else (c.done, c.seeds))
        flat = flat.cpu().numpy()
        t_reduced = time.time()
        launched = {k: v - before.get(k, 0)
                    for k, v in kernels.launches.items()
                    if v - before.get(k, 0)}
        with open(os.path.join(job.out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"launches": launched,
                       "seconds": t_reduced - t0,
                       "start_s": t_entry - job.t_spawn,
                       "setup_s": t0 - t_entry,
                       "render_s": t_rendered - t0,
                       "reduce_s": t_reduced - t_rendered,
                       "t_end": time.time(), "done": c.done,
                       "mf_dist": os.environ.get("RENE_MF_DIST"), **info},
                      f)
        if rank == 0:
            host = dict(zip(SUMS, flat))
            out = R.film_result(job.config, host,
                                flat[3] if c.sq_sum is not None else None,
                                done, seeds)
            out.pop("config")
            out.update(total_rays=rays, effective_spp=done)
            with open(os.path.join(job.out_dir, "film.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def render_multichip(scene, spp: int, seed: int = 0,
                     mesh: Optional[Mesh] = None, tile_rays: int = 1 << 18,
                     mode: str = "samples", engine: str = "auto",
                     use_bvh: Optional[bool] = None,
                     want_var: bool = False) -> dict:
    """Render a FlatScene over the ranks of `mesh` (`make_mesh()` by
    default) in `mode` (MODES) with `engine` (render.ENGINES, resolved as
    a single-device render resolves it). Returns the reference's dict,
    `color`, `normal`, `albedo` ((H, W, 3) float32, averaged),
    `total_rays`, `effective_spp` and `config`, and the port's
    `wall_time` (seconds from the ranks' start to the film on the host),
    `rank_seconds` (each rank's render and reduce), `ranks` (per rank:
    those seconds, split into `render_s` (its runner built and run) and
    `reduce_s`; `start_s` from the spawn to its first line, `setup_s` to
    the ranks' barrier, `exit_s` from its results to the join; its
    launches, samples done and `rank_chunks`' info), `launches` (CUDA
    launches summed over ranks), `kernel_launches` (by kernel, summed),
    `engine` and `backend`; with `want_var`, `varmean` over every rank's
    chunks. `use_bvh` and `tile_rays` are the XLA engine's.

    On the card the scene's kernel libraries are built before the ranks
    start, so that no two ranks build one at once."""
    if mode not in MODES:
        raise ValueError(f"unknown multichip mode {mode!r} (expected "
                         f"'samples' or 'tiles')")
    mesh = mesh or make_mesh()
    buffers_np, config = build_device_scene(scene)
    runner = R._runner(engine, buffers_np, config)
    if runner == "wave" and mode == "tiles":
        raise ValueError("the wave engine renders samples mode only; tiles "
                         "mode is the megakernel's and the XLA engine's")
    if runner != "xla":
        P.slice_supported(buffers_np, config)   # NotImplementedError
        if mesh.devices[0].type == "cuda":
            kernels.build(names=R.runner_libraries(buffers_np, config,
                                                   engine))
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="rene_mesh_") as tmp:
        job = _Job(buffers_np, config, runner, int(spp), int(seed), mode,
                   bool(want_var), use_bvh, int(tile_rays), mesh.devices,
                   mesh.backend, "file://" + os.path.join(tmp, "store"),
                   tmp, torch.get_num_threads(),
                   logging.getLogger("rene_tpu_torch").getEffectiveLevel(),
                   time.time())
        job_file = os.path.join(tmp, "job.pkl")
        with open(job_file, "wb") as f:
            pickle.dump(job, f)
        mp.start_processes(_rank_main, args=(job_file,), nprocs=mesh.size,
                           join=True, start_method="spawn")
        t_joined = time.time()
        with open(os.path.join(tmp, "film.pkl"), "rb") as f:
            out = pickle.load(f)
        wall = time.time() - job.t_spawn
        ranks = []
        for r in range(mesh.size):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    launched = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launched[k] = launched.get(k, 0) + v
    for r in ranks:     # from its results written to its exit
        r["exit_s"] = t_joined - r.pop("t_end")
    out.update(config=config, wall_time=wall, ranks=ranks,
               rank_seconds=[r["seconds"] for r in ranks],
               launches=sum(launched.values()), kernel_launches=launched,
               engine={"wave": "wave", "xla": "xla"}.get(runner, "pallas"),
               backend=mesh.backend)
    log.info("multichip: %d rank(s) (%s), mode %s, %s engine, effective "
             "spp %d, %.3f s (ranks %s s)", mesh.size, mesh.backend, mode,
             out["engine"], out["effective_spp"], wall,
             ", ".join(f"{s:.3f}" for s in out["rank_seconds"]))
    return out
