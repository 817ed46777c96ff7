#!/usr/bin/env python3
"""GPU smoke run of rene_tpu_torch, the PyTorch/CUDA port of rene-tpu.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits nonzero without printing a result
when either is missing or any check fails. Phases:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. the build of csrc/mega_path.cu and csrc/wave.cu with nvcc, every
   kernel variant at once (timed, ptxas registers and spills shown);
3. the K1a variant vs its plain version on the card: an inline 128x64
   scene with all 8 material types, emissive sphere and quad, a distant
   light and the tent filter at maxdepth 16, 4 spp, the same seed for both;
4. the K1a main path: `python -m rene_tpu_torch.cli` on an inline Cornell
   box at 1024x1024 and 64 spp, with normal and albedo AOVs;
5. that path's kernel launch against the plain version: the 64-spp chunk
   over 1024x1024 (128 TPU-sized tiles of lanes) with the CLI's chunk
   seed, held to the same limits as phase 3; then timing of the kernel
   and the plain version at the main path's shape (a 1-spp chunk);
6. the mesh variant vs its plain version on the card, 128x64 x 2 spp:
   the eight materials on a 2,310-triangle mesh, 12 shared-BLAS
   instances, and 100 table spheres with 24 table lights;
7. the mesh main path through the CLI: `scenes.big_mesh_scene`, a
   131,072-triangle surface plus 8 instances of a 4,096-triangle sphere,
   at 1280x720 x 16 spp with normal and albedo AOVs;
8. that path's launch shape against the plain version: one 1-spp chunk
   at 1280x720 with the CLI's chunk seed, the plain version on a strided
   sample of ~131k of its lanes, both sides at maxdepth 6, in one plain
   walk with those of its launches at pack 4 and 16 (phase 25); the mesh
   walk alone, the ray-cast probe on the rays the plain version casts on
   ~131k sampled pixels, against the plain walk; then
   timing of the kernel (CUDA events) over the whole film;
9. the wave kernels' registers and spills (ptxas, from the phase-2 build):
   K2 in both variants, K3 and K4, and K2's path block floors
   (`PATH_MIN_BLOCKS` of csrc/wave.cu);
10. whole waves of the wave kernels (K3, K2 and, sorted by `dma`, K4)
    against the same waves of their plain versions on the card, 128x64
    x spw 4: the materials, mesh-materials and instanced scenes; one K2
    launch of the immediates variant against plain and timed;
11. the wave main path through the CLI: `big_mesh_scene` at maxdepth 50
    (a deep big-mesh scene, the reference's rule for its wave engine) at
    1280x720 x 16 spp with `--engine wave`, then again at a second seed,
    and with `--engine pallas` at both seeds: the Mrays/s, the image
    means held to each other; and
    the Cornell box of phase 4 at 16 spp with `--engine wave` (the K2
    immediates variant);
12. full-shape checks and timing on the deep scene: K3 at 1280x720 x spw
    16 against plain; K4 on that state against plain and against
    `index_select` (its time over `index_select`'s logged); K2 at the main
    path's own launches, the first (k 1,
    every lane alive) and the fifth (k 4, after four steps and sorts),
    each run over the whole state, timed, and its output held against
    the plain version on a strided sample of ~131k of the launch's alive
    lanes; the same two launches on the Cornell box of phase 11 (1024x1024
    x spw 16, the immediates variant); the 16-spp wave once more sorted by
    `dma` (its own path: K3, K2, K4), its film against the `gather` film;
    the wave's device time split into init, K2, sorts and finish; the
    linear radiance means of the wave and the megakernel at two seeds
    each; one K2 launch at 320x180 x spw 2 against plain;
13. textures (K1b) in every kernel variant against the plain versions on
    the card: `textured_scene` with a solid, checker, image and
    scale-of-image background, `env_scene` without and with an emitter
    and the small `textured_mesh_scene`, each at 128x64 x 4 spp
    through the megakernel and as whole waves (spw 4, `gather`); the env
    scenes once more with the env tables taken away, which must change
    the image (the env-map light sampling is in use);
14. the textured main path through the CLI: `textured_mesh_scene` (the
    big mesh's geometry with uv, a 2048 x 2048 Kd map on the vase, 1024 x
    1024 Kd and roughness maps on the instanced spheres, an opacity map, a
    checker floor, a 2048 x 1024 HDR env map with env-map light sampling)
    at 1280x720 x 16 spp with `--engine auto`, and at maxdepth 50 with
    `--engine wave`, the launch counts set to 0 before each;
15. that path's 1-spp megakernel launch and its first K2 launch over the
    whole film or state, timed, each held against the plain version on a
    strided sample of ~131k lanes; the textured deep wave's fifth K2
    launch (k 4, after four launches and sorts) over the whole state, held
    against plain on ~131k sampled alive lanes as in phase 12 (the path
    lane loop with texture code at k > 1);
16. the volpath body (K1e) in its four variants against the plain
    versions on the card: `fog_scene`, `fog_env_scene` and the small
    `fog_mesh_scene` (cut to maxdepth 8) at 128x64 x 4 spp through the
    megakernel (the small mesh at 2 spp) and as whole waves (spw 4,
    `gather`; the small mesh also sorted by `dma`); then
    `fog_scene` with its media table zeroed, which must change the image
    (the medium is in use); then the benchmark's Cornell smoke scene
    (port_bench/scenes/cornell_smoke.py) at the book's 600x600, whose
    tables select the immediates build's queued instance (its march
    queue, csrc/vol_queue.cuh; its counting build's march steps all from
    the queue), at 2 spp under both samplers against the plain version
    on a strided sample of ~131k lanes;
17. the volpath main path through the CLI: `fog_mesh_scene` (the big
    mesh's geometry in a fog box, maxdepth 64) at 1280x720 x 16 spp with
    `--engine auto` and `--engine wave`, and `fog_scene` at the same film
    with both engines (the immediates variants), the launch counts set to
    0 before each; the two engines' linear radiance means on the fog mesh
    held to each other at two seeds;
18. that path's 1-spp megakernel launch and its first volpath K2 launch,
    and the same two of `fog_scene`, over the whole film or state, timed
    at their scenes' depth and held against the plain version on a
    strided sample of ~131k lanes, both sides cut to maxdepth 8 (the fog
    mesh's in one plain walk with those of its launch at pack 4, phase 25);
    the real ray casts per nominal ray of the main path, counted by the
    plain version on that sample; the fifth K2 launch (k 4, after four
    launches and sorts, lanes parking inside it) of the fog mesh's and
    the fog scene's waves at maxdepth 8, independent and Sobol, over the
    whole state, held against plain on ~131k sampled alive lanes as in
    phase 12, and by the sample's radiance means; the Cornell smoke
    scene's 100-spp launch at 600x600 (the benchmark's chunk), timed
    beside its bound;
19. the Sobol probe (P-r3ac, `sobol_probe`): one launch on 2^22 int32
    inputs, its path, then bit for bit against its plain version, timed;
20. the Sobol instances (`Sampler "sobol"`) against their plain versions on
    the card, megakernel and whole waves (`gather`; the mesh also `dma`):
    `materials_scene` and `fog_scene` at 128x64 x 4 spp, `mesh_materials_
    scene` at 2 spp, `fog_env_scene`, and the small fog mesh at 64x32 x 1
    spp (spw 2) and maxdepth 8; the independent instance on the same
    tables must trace other paths;
21. the Sobol main paths through the CLI, each with the launch counts set
    to 0 just before: the Cornell box with `Sampler "sobol"` at 1024x1024 x
    64 spp, and with `--sampler sobol` at 16 spp through `--engine wave`;
    `big_mesh_scene`, `fog_mesh_scene` and `fog_scene` at 1280x720 x 16
    spp through `auto` and `wave` (and the big mesh's independent wave);
    Mrays/s beside the independent runs;
22. full-shape launches: the 1-spp Sobol Cornell launch held against its
    plain version on ~131k sampled lanes, and the first Sobol K2 launch of
    each of the four wave main paths through `k2_launch`; each timed
    against its independent instance on the same input, in turns, as are
    the Sobol 1-spp launches of the big mesh, fog and fog mesh, held to
    plain on ~131k sampled lanes at maxdepth 6, 8 and 8 (the mesh scenes'
    in one plain walk with those of their packed launches, phase 25);
23. the sampler's worth: the reference's Sobol test scene at 256x256,
    Sobol at 32 spp against independent at 32 spp, mean absolute pixel
    error against a 4096-spp independent render (err_s < 0.85 err_i, the
    reference's factor); the Sobol and independent Cornell linear means at
    64 spp within 1e-3;
24. lanes past 2^24: K3 over the 25.2 M lanes of a 1024x1024 x spw 24 wave,
    independent and Sobol; lanes 2^24 .. 2^24 + 4096 read back: the lane
    row equal to each lane's index, the initial streams pairwise distinct,
    the other integer rows (`want` among them) and the camera rays (which
    follow the Sobol sample index) equal to the plain version's;
25. sample-in-tile packing (K1f): the big mesh's launches at 1280x720 and
    one sample per lane at pack 4 and 16, independent and Sobol, held
    against the plain version on ~131k sampled (pixel, slot) lanes of each
    at maxdepth 6, the fog mesh's at pack 4, independent and Sobol, at
    maxdepth 8 (in phases 8, 18 and 22, in the plain walk of the same
    instance's pack-1 launch), each timed here at its scene's depth; the
    packed main paths through the CLI with RENE_MEGA_PACK (the
    big mesh at pack 16 and the fog mesh at pack 4, each independent and
    with `--sampler sobol`, one launch for 16 spp and four), the big
    mesh's image mean within 1e-2 relative of phase 7's pack-1 render and
    its first-hit normals within 0.05 mean absolute difference (the
    reference's checks, tests/test_pallas_cluster.py:603-630); then the
    pack sweep of `rene_tpu_torch.probe.pack_sweep` on four films (the big
    mesh at 1280x720 and 160x90, the fog mesh at 1280x720 and 320x180),
    packs 1 / 4 / 16 at 16 spp, CUDA events and render() (`python -m
    rene_tpu_torch.probe --pack-sweep` adds a film and 64 spp);
26. the Mosaic probes: P-r3n (`rowslice_probe`) bit for bit for its three
    modes, P-r3w (`mxu_probe` hi, def, vpu at 200 reps per launch) within
    1e-5 of |B| |R| of their plain versions and bit for bit,
    through `rene_tpu_torch.probes`' run; their plain versions timed; the
    bounds at the card's TF32, BF16 and FP32 rates;
27. resumable renders and the denoisers: the big mesh (megakernel) and
    the deep mesh (`--engine wave`) at 1280x720 x 32 spp with want_var
    (two chunks of 16) through `render`, unbroken, with a checkpoint and
    stopped by `progress` at the second chunk (the checkpoint then holds
    the first), and resumed: the resumed films and varmean equal the
    unbroken ones bit for bit; then the CLI from a copy of each
    checkpoint with `--resume --denoiser cnn --unet-weights` (rene_tpu's
    unet.msgpack, read as a user's file); a-trous and the U-Net on the
    card against the port's CPU run on the big mesh's film (the CPU
    tests' tolerances), and the U-Net on cuDNN's TF32 for the record;
    the denoisers' times by CUDA events at 1280x720 and 1024x1024, one
    `save_checkpoint` of a 1280x720 film, the big mesh's render loop at
    one chunk of 32 against two of 16 (want_var), in turns; `--warm-cache`
    on both engines, naming the libraries;
28. the XLA engine (plain PyTorch on the card, no kernel of its own):
    its path and volpath loops on the card against the same engine on the
    CPU, per pixel by the card's limits and by their ray totals, on the
    same uint32 seed at 64x64 x 2 spp: the Cornell box (the matrix-product
    intersector), the mesh-materials scene with the BVH walk forced, and
    two scenes the kernels refuse, the checker-metal scene and the fog
    scene with 65 stretched spheres; then through the CLI the Cornell box
    at 1280x720 x 4 spp with `--engine xla`, its linear image mean within
    rtol 0.1 of the megakernel's at the same spp (the reference's own
    engine check), the checker-metal scene at 1280x720 x 4 spp through
    `auto`, the forced-BVH mesh (`--bvh on`) at 256x128 x 1 spp with the
    port's BVH tile cap (2^18 lanes) and once more with the reference's
    (2^14), the two films held to each other, and the refused fog scene at
    320x180 x 2 spp through `auto`; the CUDA kernels torch launches per
    XLA render and per loop iteration (torch.profiler, a 64x64 Cornell box
    at 1 spp).

29. renders over ranks of torch.distributed (parallel/shard.py), two
    ranks on the one card over gloo: the Cornell box at 1024x1024 x 16
    spp through the megakernel in tiles mode, its film the single-device
    render's bit for bit, and in samples mode, its linear mean within
    1e-3 of the single device's at the same spp and its film the host's
    sum of the two ranks' launches at the shifted seeds by the card's
    per-pixel rule; the big mesh at pack 16 in tiles mode against the
    single device by the per-pixel rule; the deep mesh through the wave
    engine in samples mode, its mean held; the XLA engine on a 64x64
    Cornell box in both modes against the same render on CPU ranks; one
    rank over NCCL (the single device's film) and two ranks on one card
    over NCCL (the message NCCL refuses them with is logged); `--devices
    2` through the CLI (exit 1 with the reference's message on one card)
    and `--dump-module` (the PTX of the Cornell box's library); each
    render's wall time beside the single device's: two ranks on one card
    measure the process model's overhead, not a scaling;
30. the denoiser's trainer on the card: `render_pairs` of the Cornell box
    at 256x256 (noisy 4 and 32 spp, clean 512) and 64 synthetic pairs,
    200 steps of `train` at 16 features, the loss under 0.75x of its first
    ten steps' mean (the reference's slow check), the step-0 gradients
    against the CPU's (each leaf within 1e-4 of its largest |g|), ms a
    step (CUDA events), and the saved weights through the CLI with
    `--denoiser cnn --unet-weights`.

The per-pixel rule and the card's limits are rene_tpu_torch.checks'. Each
path run (phases 4, 7, 11, 14, 17, 19, 21, 25, 26, 27, 28, 30 and the
`dma` wave of 12) starts
with every launch count set to 0 and reads them just after; comparison
launches are not counted. The plain versions run on the card, for the
waves of phases 10, 13, 16 and 20 through rene_tpu_torch.kernels'
wrappers swapped for them.

Each kernel's bound is the larger of its bytes over 3.35 TB/s (each input
read once, each output written once) and its FP32 operations over 67
TFLOP/s (the H100 SXM's non-tensor FP32 peak, NVIDIA's data sheet). The
operations are the ray-cast tests this run's inputs need, counted by the
plain walk (rene_tpu_torch.ops.bvh.tests) or from the rays and the
immediates, at the costs in OPS of rene_tpu_torch/bounds.py; shading is
not counted, so the bound is a lower one. A volpath bounce casts other
rays than its nominal count (a march of closest hits per light): its
immediates are tested once per cast the plain version counts
(rene_tpu_torch.ops.intersect.casts). A textured launch reads of the
atlas the texels its hits and misses fetch
(rene_tpu_torch.ops.texture.counts: four 4-byte words per textured slot)
and never more than the whole atlas once: the repeated fetches of a
texel come out of the caches.

Earlier paths cut to keep the run short (the plain walk's time goes with
its bounces, not with its lanes): phase 6's three small mesh scenes run
at 2 spp, and phase 8 holds the big mesh's launch against the plain
version at maxdepth 6, both sides, and times it at the scene's own 17;
phase 16 runs the small fog mesh at maxdepth 8 (through the megakernel
at 2 spp), and phase 18 compares the fog mesh's launch at maxdepth 8,
both sides, and times it at 64: the volpath bounces past depth 8 are
held to the reference only by the CPU tests against the JAX kernels
and, on the card, by the two engines' means of phase 17; phase 22
holds the Sobol big mesh's launch to plain at maxdepth 6 and the fog's
and fog mesh's at 8, as phases 8 and 18 do. The sampled lanes of one
instance's launches at several packs (phase 25's) go through the plain
walk of its pack-1 launch, whose time goes with its bounces more than
with its lanes.
The seconds of every phase are logged.

Outputs go to chiprun_out/smoke/ of the checkout, the textured scenes and
their image files to build/smoke_scenes/. The line before the
last is a JSON object describing each kernel; the last line is
{"ok": true, "device": {...}}.
"""
import contextlib
import dataclasses
import json
import logging
import os
import re
import subprocess
import sys
import time

# the bounds (rene_tpu_torch/bounds.py): the card's rates, the operations
# of a ray-cast test, the rows a K2 launch moves, the plain versions'
# counts; without the package beside it, the smoke stops here
from rene_tpu_torch.bounds import (BF16_OPS, FP32_OPS, K2_ROWS, K2_VOL_ROWS,
                                   TF32_OPS, bound, cast_ops, moved_bytes,
                                   plain_counts, reset_counts)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "smoke")
SCENE_DIR = os.path.join(ROOT, "build", "smoke_scenes")
MAIN_SPP, MAIN_SEED = 64, 1
MESH_SPP, MESH_W, MESH_H = 16, 1280, 720
DEEP_DEPTH = 50
# the wave and megakernel renders of the deep scene: image means (8-bit
# PNG, 0-255) within this relative difference. The engines draw other
# samples; two seeds of the megakernel read 1.0e-5 apart, and the wave
# engine on the JAX interpret-mode lane streams 4.3e-3 from it (PERF.md
# section 6)
MEAN_REL = 1e-3
# lanes of a full-shape launch held against the plain version: a strided
# sample of a K2 launch's alive lanes or of a mesh megakernel launch's
# pixels (a lane's result depends on its own input row or pixel only)
SAMPLE_LANES = 1 << 17
# samples per pixel of the small mesh scenes of phase 6, and the maxdepth
# at which phase 8 compares the big mesh's launch
SMALL_MESH_SPP = 2
BIG_MESH_CHECK_DEPTH = 6
# the volpath main path: maxdepth of its plain comparisons (phases 16 and
# 18), spp of the small volpath scenes (phase 16) and of the small fog
# mesh's megakernel comparison, whose plain walk took 96.5 s at 4 spp and
# 50.5 s at 2
VOL_CHECK_DEPTH = 8
VOL_SPP = 4
VOL_MESH_SPP = 2
# the benchmark's Cornell smoke scene (phases 16 and 18): its film, the
# spp of its launches held against the plain version, and of its timed
# launch (the benchmark's chunk)
SMOKE_SIZE = 600
SMOKE_CHECK_SPP = 2
SMOKE_SPP = 100
# the Sobol sampler: the probe's inputs and its integer operations per
# input (counted in csrc/wave.cuh probe_lane, at the FP32 rate of OPS);
# the reference's own test of the sampler (tests/test_pallas.py:615-667)
# at 256x256: spp of the two renders and of the independent reference,
# and the factor Sobol's mean pixel error must stay under
PROBE_N = 1 << 22
PROBE_OPS = 200
SOBOL_TEST_SIZE, SOBOL_TEST_SPP, SOBOL_REF_SPP = 256, 32, 4096
SOBOL_ERR_FACTOR = 0.85
# the wave whose lanes pass 2^24: 1024x1024 at auto_spw's 24 lanes per
# pixel (5000 spp), and the lanes read back
LANES24_SPW = 24
LANES24 = ((1 << 24), (1 << 24) + 4096)
# the packs beside 1 at which the mesh builds' launches are held to plain
# (path, volpath): in the plain walk of their pack-1 launch (phases 8, 18
# and 22), timed in phase 25
PATH_PACKS, VOL_PACKS = (4, 16), (4,)
# the films of phase 25's pack sweep (at 16 spp)
SWEEP_FILMS = (("big_mesh", 1280, 720), ("big_mesh", 160, 90),
               ("fog_mesh", 1280, 720), ("fog_mesh", 320, 180))
# phase 27: spp of the resumable renders (want_var: two chunks of 16), the
# U-Net's weights as a user passes them, the denoisers' tolerances on the
# card against the CPU (tests/test_torch_denoise.py's against rene_tpu)
# and the second film they are timed on
RESUME_SPP = 32
UNET_WEIGHTS = os.path.join("rene_tpu", "models", "weights", "unet.msgpack")
ATROUS_TOL, UNET_TOL = (1e-6, 1e-5), (1e-5, 1e-4)
DENOISE_SQUARE = 1024
# phase 28, the XLA engine: the card against the CPU (film, spp, a uint32
# seed past 2^31), the full-width renders' spp and the reference's rtol
# between the engines' means, the forced-BVH mesh's and the refused fog
# scene's films and spp, and the profiled render's film
XLA_CHECK_W, XLA_CHECK_H, XLA_CHECK_SPP, XLA_SEED = 64, 64, 2, 3000000001
XLA_SPP, XLA_MEGA_RTOL = 4, 0.1
XLA_BVH_W, XLA_BVH_H, XLA_BVH_SPP = 256, 128, 1
# the reference's BVH tile cap (rene_tpu/render.py:218), timed beside the
# port's
XLA_REF_BVH_TILE = 1 << 14
XLA_FOG_W, XLA_FOG_H, XLA_FOG_SPP = 320, 180, 2
XLA_PROFILE_W = 64
# phase 29, ranks on the one card: the Cornell box's film and spp, the
# big mesh's pack, the linear means' limit between a render over ranks
# and one device's at the same spp, the XLA engine's film and spp, how
# long the two NCCL ranks on one card may take to be refused
MC_SIZE, MC_SPP, MC_PACK, MC_MEAN_REL = 1024, 16, 16, 1e-3
MC_XLA_SIZE, MC_XLA_SPP = 64, 2
MC_NCCL_TIMEOUT_S = 120
# phase 30, the trainer: render pairs of the Cornell box (res, noisy spp,
# clean spp), synthetic patches, steps, features, seed, the reference's
# slow check (the last ten steps' mean loss under this share of the first
# ten's) and the gradients' limit (tests/test_torch_train_denoiser.py's)
TRAIN_RES, TRAIN_NOISY, TRAIN_CLEAN = 256, (4, 32), 512
TRAIN_SYNTHETIC, TRAIN_STEPS, TRAIN_FEATURES, TRAIN_SEED = 64, 200, 16, 0
TRAIN_FALL, TRAIN_GRAD_TOL = 0.75, 1e-4


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def write_scene(name, src, directory=None):
    path = os.path.join(directory or OUT_DIR, name + ".pbrt")
    with open(path, "w") as f:
        f.write(src)
    return path


def buffers_for(path):
    from rene_tpu_torch.scene import build_device_scene, load_scene
    return build_device_scene(load_scene(path))


def tables_for(path, device):
    from rene_tpu_torch.integrators import mega_path as M
    from rene_tpu_torch.scene import pack as P
    return M.device_tables(P.pack_tables(*buffers_for(path)), device)


def reset_launches():
    from rene_tpu_torch import kernels
    for k in kernels.launches:
        kernels.launches[k] = 0


def cli_path(name, src, spp, size, what, engine="auto", seed=MAIN_SEED,
             directory=None, sampler="auto", extra=(), suffix=""):
    """Render `src` through cli.main on the card with every launch count
    set to 0 just before; check the PNG shapes and a non-black image.
    The scene file goes to `directory` (where its image files lie), by
    default the output directory; `src` None renders the file written
    there before. `sampler`: the CLI's --sampler; `extra`: more flags;
    `suffix`: added to the PNGs' names. Returns (scene path, launch
    counts, {rate, mean, records: the CLI's log messages})."""
    import torch
    from rene_tpu_torch import cli, kernels
    from rene_tpu_torch.utils.film import read_png
    scene_path = (write_scene(name, src, directory) if src is not None
                  else os.path.join(directory or OUT_DIR, name + ".pbrt"))
    tag = f"{name}_{engine}_{seed}" + ("" if sampler == "auto"
                                       else "_" + sampler) + suffix
    paths = [os.path.join(OUT_DIR, f"{tag}{k}.png")
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
    reset_launches()
    t0 = time.time()
    rc = cli.main([scene_path, "--spp", str(spp), "--seed", str(seed),
                   "--output", paths[0], "--aov-normal", paths[1],
                   "--aov-albedo", paths[2], "--device", "cuda",
                   "--engine", engine, "--sampler", sampler, *extra])
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
    if not means[f"{tag}.png"] > 0.0:
        raise RuntimeError("the rendered image is black")
    log(f"main path ({what}, {spp} spp, engine {engine}, seed {seed}, "
        f"sampler {sampler}): "
        f"launches {json.dumps(launches)}, {mrays:.1f} Mrays, render "
        f"{render_s:.3f} s, {rate:.1f} Mrays/s, cli wall {wall:.3f} s, "
        f"png means {json.dumps(means)}")
    return scene_path, launches, {"rate": rate, "mean": means[f"{tag}.png"],
                                  "records": [r.getMessage()
                                              for r in records]}


@contextlib.contextmanager
def plain_wave_kernels():
    """The wave runner's kernel wrappers swapped for the plain versions,
    so that a runner on CUDA tensors runs them on the card."""
    from rene_tpu_torch import kernels
    from rene_tpu_torch.integrators import wave as WV
    saved = (kernels.wave_genesis, kernels.wave_path, kernels.wave_permute)

    def genesis(tabs, pxf, pyf, n_real, seed, base, rem, stream):
        return WV.genesis_ref(tabs["cam_f"], pxf, pyf, tabs["width"],
                              tabs["width"] * tabs["height"], n_real, seed,
                              base, rem, stream, tabs["sobol"])

    kernels.wave_genesis, kernels.wave_path, kernels.wave_permute = (
        genesis, WV.wave_step_ref, WV.permute_ref)
    try:
        yield
    finally:
        kernels.wave_genesis, kernels.wave_path, kernels.wave_permute = saved


def lane_agreement(s_k, s_p):
    """Shares of lanes of two wave states that agree on every row by the
    per-pixel rule's radiance tolerance, and on the key row bit for
    bit."""
    import torch
    from rene_tpu_torch import checks
    from rene_tpu_torch.integrators import wave as WV
    ok = ((s_k - s_p).abs() <= checks.RAD_ATOL
          + checks.RAD_RTOL * s_p.abs()).all(0)
    key = (s_k[WV.WROW_KEY].view(torch.int32)
           == s_p[WV.WROW_KEY].view(torch.int32))
    return float(ok.double().mean()), float(key.double().mean())


def wave_at(run, seed, want, step):
    """The state of a wave of `run` just before its K2 launch `step`, and
    that launch's lane bound, driven as run_dev drives it: genesis, then
    per step the sort over the bucketed prefix and the launch, with the
    one-step-stale alive count."""
    from rene_tpu_torch.integrators import wave as WV
    state = run.init_state(seed, want)
    prefix, counts = run.n_real, []
    for si in range(step + 1):
        if si >= 1:
            m = run.bucket(prefix)
            state = run.sort_prefix(state, m)
            last = counts[si - 2] if si >= 2 else run.n_real
            nt = min(-(-last // WV.W_TILE), m // WV.W_TILE)
            prefix = nt * WV.W_TILE
        else:
            nt = -(-prefix // WV.W_TILE)
        if si == step:
            return state, nt * WV.W_TILE
        k = WV.SCHEDULE[min(si, len(WV.SCHEDULE) - 1)]
        state, n_alive = run.kernel_step(k, state, seed, si, nt, want)
        counts.append(int(n_alive))


def film(out):
    import numpy as np
    return np.concatenate([np.asarray(out[k]).T
                           for k in ("radiance", "normal", "albedo")])


def film_rel(a, b):
    """Largest difference of two films' per-pixel sums, relative to the
    larger of 1 and the sum: two sorts of the same wave differ only in
    the order of each pixel's sum."""
    import numpy as np
    fa, fb = film(a), film(b)
    return float((np.abs(fa - fb) / np.maximum(np.abs(fb), 1.0)).max())


class StopRender(Exception):
    """Raised by phase 27's progress callback to stop a render."""


def events_ms(fn, reps=3):
    """CUDA-event milliseconds of each of `reps` calls of `fn`, after one
    call that is not timed."""
    import torch
    fn()
    out = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def cornell_smoke_check(dev):
    """Phase 16's Cornell smoke scene (port_bench/scenes/cornell_smoke.py)
    at the book's SMOKE_SIZE square: its tables select the immediates
    volpath build's queued instance (every march step of its counting
    build's launch comes from the block's queue); under both samplers the
    megakernel's SMOKE_CHECK_SPP launch against the plain version on a
    strided sample of ~SAMPLE_LANES lanes, at the card's limits. Returns
    the independent tables, the largest max_abs and the plain walk's
    tests per ray (the independent one's)."""
    import torch
    from port_bench.scenes import cornell_smoke
    from rene_tpu_torch import checks, kernels, scenes
    from rene_tpu_torch.integrators import mega_path as M
    src = cornell_smoke.scene(SMOKE_SIZE, SMOKE_SIZE)
    res = {"max_abs": 0.0}
    for smp in ("independent", "sobol"):
        tabs = tables_for(write_scene(
            f"cornell_smoke_{smp}",
            scenes.with_sampler(src) if smp == "sobol" else src,
            SCENE_DIR), dev)
        if kernels.variant(tabs) != "mega_volpath" + (
                kernels.SOBOL if smp == "sobol" else "") \
                or tabs["lights"].shape[0] != 0:
            raise RuntimeError(f"Cornell smoke ({smp}): runs "
                               f"{kernels.variant(tabs)}")
        if smp == "independent":
            _, c = kernels.mega_volpath_counts(tabs, 7, 1)
            log(f"Cornell smoke {SMOKE_SIZE}x{SMOKE_SIZE} x 1 spp, counting "
                f"build: {json.dumps(c)}")
            if not 0 < c["queued_steps"] == c["march_steps"]:
                raise RuntimeError("Cornell smoke: its marches do not run "
                                   "from the block's queue")
            res["tabs"] = tabs
        n = SMOKE_SIZE * SMOKE_SIZE
        lanes = torch.arange(0, n, max(1, n // SAMPLE_LANES), device=dev)
        seed = 4100000123
        out = kernels.mega_path(tabs, seed, SMOKE_CHECK_SPP)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"Cornell smoke ({smp}): kernel output is "
                               f"not finite")
        out = out.index_select(1, lanes)
        torch.cuda.synchronize()
        reset_counts()
        t = time.time()
        ref = M.path_lanes_ref(tabs, seed, SMOKE_CHECK_SPP, lanes=lanes)
        torch.cuda.synchronize()
        plain_s = time.time() - t
        a = checks.agreement(out, ref)
        what = (f"Cornell smoke {SMOKE_SIZE}x{SMOKE_SIZE} x "
                f"{SMOKE_CHECK_SPP} spp, {smp}")
        log(f"kernel vs plain ({what}, seed {seed}, {lanes.numel()} sampled "
            f"lanes, plain {plain_s:.1f} s): " + json.dumps(a))
        checks.check_card(a, what)
        res["max_abs"] = max(res["max_abs"], a["max_abs"])
        if smp == "independent":
            res["plain_ms"] = plain_s * 1e3
            res["sampled"] = lanes.numel()
            res["tests"] = {k: v / a["rays_ref"]
                            for k, v in plain_counts().items()}
    return res


def cornell_smoke_timing(chk, card):
    """Phase 18's Cornell smoke launch: the SMOKE_SPP launch over the
    whole film of `chk` (cornell_smoke_check's), CUDA events, the median
    of five, beside its bound from the plain walk's tests per ray scaled
    by the launch's rays. Returns (ms, bound)."""
    import numpy as np
    from rene_tpu_torch import kernels
    tabs = chk["tabs"]
    ms = float(np.median(events_ms(
        lambda: kernels.mega_path(tabs, 11, SMOKE_SPP), 5)))
    rays = float(kernels.mega_path(tabs, 11, SMOKE_SPP)[9].sum())
    tests = {k: v * rays for k, v in chk["tests"].items()}
    bnd = bound(moved_bytes(tabs, tests) + 10 * 4 * SMOKE_SIZE * SMOKE_SIZE,
                cast_ops(tabs, rays, tests))
    log(f"timing (Cornell smoke {SMOKE_SIZE}x{SMOKE_SIZE}, {SMOKE_SPP} spp, "
        f"maxdepth {tabs['max_depth']}, the queued instance): kernel "
        f"{ms:.3f} ms, {rays:.0f} nominal rays, "
        f"{SMOKE_SIZE * SMOKE_SIZE * SMOKE_SPP / ms / 1e3:.1f} Msamples/s; "
        f"bound {bnd[0]:.4f} ms ({bnd[1]}; plain walk tests per ray "
        f"{json.dumps(chk['tests'])}) [{card}]")
    return ms, bnd


def within(a, b, tol):
    """Largest |a - b| and whether every element is within atol + rtol
    |b|."""
    import numpy as np
    d = np.abs(a - b)
    return float(d.max()), bool((d <= tol[0] + tol[1] * np.abs(b)).all())


def resume_and_denoise(dev, card, paths):
    """Phase 27: the big mesh (`--engine auto`, the megakernel) and the
    deep mesh (`--engine wave`) at 1280x720 x RESUME_SPP with want_var,
    each rendered unbroken, stopped by `progress` at its second chunk (the
    checkpoint then holds the first), resumed, all through `render` and
    held bit for bit; then the CLI from a copy of the checkpoint with
    `--resume --denoiser cnn --unet-weights`; the denoisers on the card
    against the CPU on the big mesh's film; `--warm-cache`; the times."""
    import shutil

    import numpy as np
    import torch
    from rene_tpu_torch import cli, kernels
    from rene_tpu_torch import render as RD
    from rene_tpu_torch.models import denoise as DN
    from rene_tpu_torch.scene import load_scene
    from rene_tpu_torch.utils import checkpoint as CK
    weights = os.path.join(ROOT, UNET_WEIGHTS)
    shape = (MESH_H, MESH_W, 3)
    for name, engine, main_kernel, first_kernel in (
            ("big_mesh", "auto", "mega_path_mesh", "mega_path_mesh"),
            ("deep_mesh", "wave", "wave_path_mesh", "wave_genesis")):
        t0 = time.time()
        scene = load_scene(paths[name])
        kw = dict(spp=RESUME_SPP, seed=MAIN_SEED, device="cuda",
                  engine=engine, want_var=True)
        ck = os.path.join(SCENE_DIR, f"{name}_resume.npz")
        if os.path.exists(ck):
            os.unlink(ck)
        runs, launches = {}, {}
        reset_launches()
        runs["unbroken"] = RD.render(scene, **kw)
        launches["unbroken"] = dict(kernels.launches)
        stops = []

        def progress(done, spp, ms):
            stops.append(done)
            if len(stops) == 2:
                raise StopRender

        reset_launches()
        try:
            RD.render(scene, checkpoint=ck, progress=progress, **kw)
            raise RuntimeError(f"{name}: the render did not stop")
        except StopRender:
            pass
        launches["stopped"] = dict(kernels.launches)
        with np.load(ck) as z:
            held = (int(z["samples_done"]), int(z["seeds"]))
        if held != (RESUME_SPP // 2, 1):
            raise RuntimeError(f"{name}: the checkpoint holds {held}")
        copy = os.path.join(SCENE_DIR, f"{name}_resume_copy.npz")
        shutil.copy(ck, copy)
        reset_launches()
        runs["resumed"] = RD.render(scene, checkpoint=ck, resume=True, **kw)
        launches["resumed"] = dict(kernels.launches)
        for label, out in runs.items():
            for k in ("color", "normal", "albedo", "varmean"):
                if out[k].shape != shape or not np.isfinite(out[k]).all():
                    raise RuntimeError(f"{name} {label}: {k} is not finite "
                                       f"of shape {shape}")
        same = {k: bool(np.array_equal(runs["unbroken"][k],
                                       runs["resumed"][k]))
                for k in ("color", "normal", "albedo", "varmean")}
        if not all(same.values()):
            raise RuntimeError(f"{name}: the resumed render is not the "
                               f"unbroken one: {same}")
        # two chunks unbroken, the first again in the stopped render, the
        # second alone in the resumed one
        firsts = [launches[k][first_kernel]
                  for k in ("unbroken", "stopped", "resumed")]
        if firsts != [2, 2, 1] or not all(
                launches[k][main_kernel] > 0 for k in launches):
            raise RuntimeError(f"{name}: launches {launches}")
        log(f"resume ({name}, engine {engine}, {MESH_W}x{MESH_H} x "
            f"{RESUME_SPP} spp, want_var, chunks of {RESUME_SPP // 2}): "
            f"the resumed film and varmean equal the unbroken ones bit for "
            f"bit; {first_kernel} launches {firsts}; render loop "
            f"{runs['unbroken']['wall_time']:.3f} s unbroken, "
            f"{runs['resumed']['wall_time']:.3f} s resumed; varmean mean "
            f"{float(runs['unbroken']['varmean'].mean()):.6g}")
        _, l_cli, r_cli = cli_path(
            name, None, RESUME_SPP, (MESH_W, MESH_H),
            f"{name}, resumed, cnn", engine=engine,
            extra=["--checkpoint", copy, "--resume", "--denoiser", "cnn",
                   "--unet-weights", weights], suffix="_resumed_cnn")
        if l_cli[first_kernel] != 1 or not any(
                m.startswith("resumed from") for m in r_cli["records"]):
            raise RuntimeError(f"{name}: the CLI did not resume: {l_cli}")
        if name == "big_mesh":
            big = runs["unbroken"]
        log(f"phase 27 {name}: {time.time() - t0:.1f} s")

    # the denoisers on the card against the port's own CPU run on the
    # big mesh's film
    c, n, a = (np.ascontiguousarray(big[k])
               for k in ("color", "normal", "albedo"))
    t0 = time.time()
    base_cpu = DN.atrous_denoise(c, n, a, device="cpu")
    cpu_atrous_s = time.time() - t0
    base_card = DN.atrous_denoise(c, n, a, device=dev)
    err_a, ok_a = within(base_card.cpu().numpy(), base_cpu.numpy(),
                         ATROUS_TOL)
    net_cpu = DN.UNetDenoiser.load(weights, device="cpu")
    net_card = DN.UNetDenoiser.load(weights, device=dev)
    t0 = time.time()
    unet_cpu = net_cpu(c, n, a, base=base_cpu).numpy()
    cpu_unet_s = time.time() - t0
    unet_card = net_card(c, n, a, base=base_cpu).cpu().numpy()
    err_u, ok_u = within(unet_card, unet_cpu, UNET_TOL)
    if not torch.backends.cudnn.allow_tf32:
        raise RuntimeError("the U-Net left cuDNN's TF32 setting off")
    # the same net with cuDNN's default TF32 convolutions, for the record
    x = torch.cat([torch.as_tensor(v, device=dev) for v in
                   (c, base_cpu.numpy(), n, a)], -1).permute(2, 0, 1)[None]
    with torch.no_grad():
        tf32 = (base_cpu.to(dev) + net_card.net(x.contiguous())[0]
                .permute(1, 2, 0)).cpu().numpy()
    err_tf32, ok_tf32 = within(tf32, unet_cpu, UNET_TOL)
    log(f"denoisers on the card vs the CPU ({MESH_W}x{MESH_H} big mesh "
        f"film): atrous max abs {err_a:.3g} (atol {ATROUS_TOL[0]}, rtol "
        f"{ATROUS_TOL[1]}: {ok_a}), U-Net max abs {err_u:.3g} (atol "
        f"{UNET_TOL[0]}, rtol {UNET_TOL[1]}: {ok_u}); the U-Net on TF32 "
        f"max abs {err_tf32:.3g} (within: {ok_tf32}); CPU seconds atrous "
        f"{cpu_atrous_s:.2f}, U-Net {cpu_unet_s:.2f}")
    if not (ok_a and ok_u):
        raise RuntimeError("a denoiser on the card disagrees with the CPU")

    # their times by CUDA events at 1280x720 and 1024x1024
    g = np.random.default_rng(MAIN_SEED)
    sq = [g.random((DENOISE_SQUARE, DENOISE_SQUARE, 3)).astype(np.float32)
          for _ in range(3)]
    for label, (fc, fn, fa) in ((f"{MESH_W}x{MESH_H}", (c, n, a)),
                                (f"{DENOISE_SQUARE}x{DENOISE_SQUARE}", sq)):
        tc, tn, ta = (torch.as_tensor(v, device=dev) for v in (fc, fn, fa))
        base = DN.atrous_denoise(tc, tn, ta, device=dev)
        at_ms = events_ms(lambda: DN.atrous_denoise(tc, tn, ta, device=dev))
        un_ms = events_ms(lambda: net_card(tc, tn, ta, base=base))
        log(f"denoiser times ({label}, CUDA events, 3 calls after one): "
            f"atrous {', '.join(f'{t:.3f}' for t in at_ms)} ms; U-Net "
            f"(16 features, 3 levels) {', '.join(f'{t:.3f}' for t in un_ms)}"
            f" ms [{card}]")

    # one save_checkpoint of a 1280x720 film (three sums and sq_sum), and
    # the reference's compressed write of the same arrays, in turns
    with np.load(os.path.join(SCENE_DIR, "big_mesh_resume.npz")) as z:
        accum = {k: z[k] for k in CK.SUMS}
        sq_sum = z["sq_sum"]
    timing = os.path.join(SCENE_DIR, "save_timing.npz")
    save_s = {"save_checkpoint": [], "savez_compressed": []}
    for kind in ("save_checkpoint", "savez_compressed") * 2:
        t0 = time.perf_counter()
        if kind == "save_checkpoint":
            CK.save_checkpoint(timing, accum, RESUME_SPP, "timing", 2, sq_sum)
        else:
            np.savez_compressed(timing, sq_sum=sq_sum, **accum)
        save_s[kind].append(time.perf_counter() - t0)
    log(f"checkpoint write ({MESH_W}x{MESH_H}, three sums and sq_sum, "
        f"{os.path.getsize(timing) / 1e6:.1f} MB compressed): "
        + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)} s"
                    for k, v in save_s.items()) + f" [{card}]")
    os.unlink(timing)

    # want_var's extra chunk on the big mesh: one chunk of 32 against two
    # of 16, render-loop seconds, in turns
    scene = load_scene(paths["big_mesh"])
    loop_s = {False: [], True: []}
    for want_var in (False, True, True, False):
        out = RD.render(scene, spp=RESUME_SPP, seed=MAIN_SEED, device="cuda",
                        want_var=want_var)
        loop_s[want_var].append(out["wall_time"])
    log(f"big mesh {MESH_W}x{MESH_H} x {RESUME_SPP} spp render loop: one "
        f"chunk of {RESUME_SPP} {loop_s[False][0]:.3f} / "
        f"{loop_s[False][1]:.3f} s, two of {RESUME_SPP // 2} with want_var "
        f"{loop_s[True][0]:.3f} / {loop_s[True][1]:.3f} s [{card}]")

    # --warm-cache: the libraries the runners launch, nothing rendered
    for engine in ("auto", "wave"):
        records = []

        class Grab(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        grab = Grab()
        logging.getLogger("rene_tpu_torch").addHandler(grab)
        reset_launches()
        try:
            rc = cli.main([paths["big_mesh"], "--warm-cache", "--engine",
                           engine, "--device", "cuda"])
        finally:
            logging.getLogger("rene_tpu_torch").removeHandler(grab)
        libs = [m for m in records if m.startswith("library ")]
        if rc != 0 or not libs or any(kernels.launches.values()):
            raise RuntimeError(f"--warm-cache ({engine}): rc {rc}, {records}")
        log(f"--warm-cache (big mesh, engine {engine}): rc 0, "
            f"{'; '.join(libs)}")


@contextlib.contextmanager
def captured_renders():
    """rene_tpu_torch.render.render wrapped so that the result of every
    render inside the block (the CLI's among them) is kept in the list
    yielded."""
    from rene_tpu_torch import render as RD
    got, inner = [], RD.render

    def keep(*a, **k):
        got.append(inner(*a, **k))
        return got[-1]

    RD.render = keep
    try:
        yield got
    finally:
        RD.render = inner


def xla_engine(dev, card):
    """Phase 28: the XLA engine on the card against the CPU, through the
    CLI at full width against the megakernel, on the scenes the kernels
    refuse, with the BVH forced, and its launches per render."""
    import numpy as np
    import torch
    from rene_tpu_torch import checks, scenes
    from rene_tpu_torch import render as RD
    from rene_tpu_torch.integrators import path, volpath
    from rene_tpu_torch.ops.accel import make_accel
    from rene_tpu_torch.scene import load_scene
    from rene_tpu_torch.scene.device import to_torch
    from rene_tpu_torch.utils.checkpoint import SUMS

    # the card against the CPU, per pixel, on the same seed
    w, h = XLA_CHECK_W, XLA_CHECK_H
    pix = torch.arange(w * h)
    for name, src, force in (
            ("cornell", scenes.cornell_box(w, h), None),
            ("mesh_bvh", scenes.mesh_materials_scene(w, h), "bvh"),
            ("checker_metal", scenes.checker_metal_scene(SCENE_DIR, w, h),
             None),
            ("fog_spheres", scenes.fog_spheres_scene(w, h), None)):
        t0 = time.time()
        bn, cfg = buffers_for(write_scene(f"xla_{name}", src, SCENE_DIR))
        batch = (volpath.render_batch if cfg.integrator == "volpath"
                 else path.render_batch)
        res = {}
        for d in (dev, torch.device("cpu")):
            t = time.time()
            o = batch(to_torch(bn, d), cfg, (pix % w).to(d),
                      (pix // w).to(d), XLA_SEED, XLA_CHECK_SPP,
                      accel=make_accel(bn, cfg, d, force=force))
            rows = torch.cat([o[k].T for k in SUMS]).cpu()
            res[d.type] = (rows, float(o["rays"]), time.time() - t,
                           o["iterations"])
        card_rows, card_rays, card_s, iters = res["cuda"]
        if not bool(torch.isfinite(card_rows).all()):
            raise RuntimeError(f"XLA engine {name}: not finite on the card")
        a = checks.agreement(card_rows, res["cpu"][0])
        log(f"XLA engine card vs CPU ({name}, {w}x{h} x {XLA_CHECK_SPP} "
            f"spp, seed {XLA_SEED}, {iters} loop iterations; card "
            f"{card_s:.1f} s, CPU {res['cpu'][2]:.1f} s): rays "
            f"{card_rays:.0f} / {res['cpu'][1]:.0f}; " + json.dumps(a))
        checks.check_card(a, f"XLA engine {name}, card vs CPU")
        if abs(card_rays - res["cpu"][1]) > 1e-3 * res["cpu"][1]:
            raise RuntimeError(f"XLA engine {name}: ray totals differ")
        log(f"phase 28 {name} card vs CPU: {time.time() - t0:.1f} s")

    # full width through the CLI: the Cornell box on both engines, the
    # refused checker-metal scene through auto
    t0 = time.time()
    means = {}
    for engine in ("xla", "pallas"):
        with captured_renders() as got:
            _, l_c, r_c = cli_path(
                "xla_cornell", scenes.cornell_box(MESH_W, MESH_H)
                if engine == "xla" else None, XLA_SPP, (MESH_W, MESH_H),
                f"cornell {MESH_W}x{MESH_H}", engine=engine)
        out = got[-1]
        if out["engine"] != engine or (engine == "xla") != (
                sum(l_c.values()) == 0):
            raise RuntimeError(f"cornell {engine}: engine {out['engine']}, "
                               f"launches {l_c}")
        means[engine] = out["color"].astype(np.float64).mean(axis=(0, 1))
        log(f"cornell {MESH_W}x{MESH_H} x {XLA_SPP} spp, engine {engine}: "
            f"{out['total_rays'] / 1e6:.3f} Mrays in {out['wall_time']:.3f}"
            f" s, {out['total_rays'] / out['wall_time'] / 1e6:.2f} Mrays/s"
            + (f", {out['iterations']} loop iterations"
               if engine == "xla" else "")
            + f", linear mean {means[engine].tolist()} [{card}]")
    if not np.allclose(means["xla"], means["pallas"], rtol=XLA_MEGA_RTOL):
        raise RuntimeError(f"cornell: the XLA engine's mean "
                           f"{means['xla']} is not the megakernel's "
                           f"{means['pallas']} within rtol {XLA_MEGA_RTOL}")
    log(f"phase 28 cornell, both engines: {time.time() - t0:.1f} s")

    def refused(name, src, size, spp, extra=()):
        t0 = time.time()
        with captured_renders() as got:
            _, l_r, r_r = cli_path(name, src, spp, size,
                                   f"{name} {size[0]}x{size[1]}",
                                   engine="auto", directory=SCENE_DIR,
                                   extra=extra)
        out = got[-1]
        if out["engine"] != "xla" or sum(l_r.values()) or not any(
                "the kernels refuse" in m for m in r_r["records"]):
            raise RuntimeError(f"{name}: auto did not take the XLA engine: "
                               f"{out['engine']}, {l_r}")
        log(f"{name} {size[0]}x{size[1]} x {spp} spp through auto: "
            f"{out['total_rays'] / 1e6:.3f} Mrays in {out['wall_time']:.3f}"
            f" s, {out['total_rays'] / out['wall_time'] / 1e6:.2f} Mrays/s,"
            f" {out['iterations']} loop iterations [{card}]")
        log(f"phase 28 {name}: {time.time() - t0:.1f} s")

    refused("xla_checker_metal_full",
            scenes.checker_metal_scene(SCENE_DIR, MESH_W, MESH_H),
            (MESH_W, MESH_H), XLA_SPP)

    # the forced-BVH mesh through the CLI, then with the reference's BVH
    # tile cap: the cap does not change the image, its time is read
    t0 = time.time()
    size = (XLA_BVH_W, XLA_BVH_H)
    runs = {}
    with captured_renders() as got:
        bvh_path, l_b, _ = cli_path(
            "xla_mesh_bvh", scenes.mesh_materials_scene(*size), XLA_BVH_SPP,
            size, f"mesh materials {size[0]}x{size[1]}, BVH forced",
            engine="xla", extra=["--bvh", "on"])
    cap = RD.XLA_BVH_TILE
    runs[cap] = got[-1]
    try:
        RD.XLA_BVH_TILE = XLA_REF_BVH_TILE
        runs[XLA_REF_BVH_TILE] = RD.render(
            load_scene(bvh_path), spp=XLA_BVH_SPP, seed=MAIN_SEED,
            device="cuda", engine="xla", use_bvh=True)
    finally:
        RD.XLA_BVH_TILE = cap
    a, b = runs[cap], runs[XLA_REF_BVH_TILE]

    def rows(out):
        return np.concatenate([out[k].reshape(-1, 3).T * XLA_BVH_SPP
                               for k in ("color", "normal", "albedo")])
    agree = checks.agreement(rows(a), rows(b))
    for tile, out in runs.items():
        log(f"mesh materials {size[0]}x{size[1]} x {XLA_BVH_SPP} spp, BVH "
            f"forced, tiles of {min(tile, size[0] * size[1])} lanes: "
            f"{out['total_rays'] / 1e6:.3f} Mrays in {out['wall_time']:.3f}"
            f" s, {out['total_rays'] / out['wall_time'] / 1e6:.3f} Mrays/s,"
            f" {out['iterations']} loop iterations [{card}]")
    log(f"the BVH tile cap, the port's vs the reference's: rays "
        f"{a['total_rays']:.0f} / "
        f"{b['total_rays']:.0f}; " + json.dumps(agree))
    checks.check_card(agree, "the BVH tile cap")
    log(f"phase 28 BVH mesh: {time.time() - t0:.1f} s")

    refused("xla_fog_spheres", scenes.fog_spheres_scene(XLA_FOG_W,
                                                        XLA_FOG_H),
            (XLA_FOG_W, XLA_FOG_H), XLA_FOG_SPP)

    # the CUDA kernels torch launches per XLA render (torch.profiler)
    t0 = time.time()
    from torch.profiler import ProfilerActivity, profile
    scene = load_scene(write_scene(
        "xla_profile", scenes.cornell_box(XLA_PROFILE_W, XLA_PROFILE_W),
        SCENE_DIR))
    RD.render(scene, spp=1, seed=MAIN_SEED, device="cuda", engine="xla")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = RD.render(scene, spp=1, seed=MAIN_SEED, device="cuda",
                        engine="xla")
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(e, "device_time", None)
                  or getattr(e, "cuda_time", 0.0) for e in kern)
    if kern:
        log(f"XLA render launches (cornell {XLA_PROFILE_W}x{XLA_PROFILE_W}"
            f" x 1 spp, {out['iterations']} loop iterations): {len(kern)} "
            f"CUDA kernels, {len(kern) / max(out['iterations'], 1):.0f} per"
            f" iteration, device busy {busy_us / 1e3:.3f} ms of a "
            f"{out['wall_time'] * 1e3:.3f} ms render (profiled) [{card}]")
    else:
        log("XLA render launches: not measured (the profiler saw no CUDA "
            "kernel)")
    log(f"phase 28 profile: {time.time() - t0:.1f} s")


def _rows(out, n):
    """(9, N) per-pixel sums of a render's images averaged over n
    samples."""
    import numpy as np
    return np.concatenate([(np.asarray(out[k]).reshape(-1, 3) * n).T
                           for k in ("color", "normal", "albedo")])


def _same(a, b):
    """The images of two renders equal bit for bit."""
    import numpy as np
    return all(np.array_equal(a[k], b[k]) for k in ("color", "normal",
                                                    "albedo"))


def _refused_nccl():
    """Start two ranks on one card over NCCL, in a process group of its
    own (NCCL_DEBUG=WARN, so that NCCL says why it refuses them); returns
    a function that waits for them, killing the group whole after
    MC_NCCL_TIMEOUT_S, and gives the exit code and the lines of NCCL's
    message, or what happened instead. The mesh is built by hand:
    `make_mesh` gives ranks that share a card gloo."""
    import signal
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch\n"
            "from rene_tpu_torch import scenes\n"
            "from rene_tpu_torch.parallel import shard as S\n"
            "from rene_tpu_torch.pbrt import parse_pbrt\n"
            "from rene_tpu_torch.scene import create_scene\n"
            "if __name__ == '__main__':\n"
            "    sc = create_scene(parse_pbrt(scenes.cornell_box(64, 64)),"
            " '.')\n"
            "    S.render_multichip(sc, 1, mesh=S.Mesh("
            "(torch.device('cuda', 0),) * 2, 'nccl'), mode='tiles')\n"
            % ROOT)
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True,
                            env=dict(os.environ, NCCL_DEBUG="WARN"))
    t0 = time.time()

    def wait():
        try:
            out, _ = proc.communicate(
                timeout=max(1.0, MC_NCCL_TIMEOUT_S - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            return None, [f"no answer within {MC_NCCL_TIMEOUT_S} s (killed)"]
        lines = [ln.strip() for ln in out.splitlines()
                 if "Duplicate GPU" in ln or "NCCL error" in ln]
        return proc.returncode, (lines[:2] if lines
                                 else out.strip().splitlines()[-1:])
    return wait


def multi_device(dev, card, paths):
    """Phase 29: renders over ranks of torch.distributed on the one card
    (parallel/shard.py), each held against the single-device render."""
    import io
    import numpy as np
    import torch
    from rene_tpu_torch import checks, cli, scenes
    from rene_tpu_torch import render as RD
    from rene_tpu_torch.parallel import shard as S
    from rene_tpu_torch.scene import build_device_scene, load_scene

    two = S.make_mesh([dev, dev])
    if two.backend != "gloo":
        raise RuntimeError(f"two ranks on one card: backend {two.backend}")

    def report(what, multi, single):
        split = "; ".join(
            f"rank {i}: start {r['start_s']:.3f}, setup {r['setup_s']:.3f}, "
            f"render {r['render_s']:.3f}, reduce {r['reduce_s']:.3f}, exit "
            f"{r['exit_s']:.3f}" for i, r in enumerate(multi["ranks"]))
        log(f"{what}: {multi['effective_spp']} spp over "
            f"{len(multi['rank_seconds'])} rank(s) ({multi['backend']}), "
            f"wall {multi['wall_time']:.3f} s ({split} s), launches "
            f"{json.dumps(multi['kernel_launches'])}; one device "
            f"{single['wall_time']:.3f} s [{card}]")

    # the Cornell box, megakernel tiles mode: the single device's film
    t0 = time.time()
    corn = load_scene(write_scene("mc_cornell", scenes.cornell_box(
        MC_SIZE, MC_SIZE), SCENE_DIR))
    single = RD.render(corn, spp=MC_SPP, seed=MAIN_SEED, device=dev)
    tiles = S.render_multichip(corn, MC_SPP, seed=MAIN_SEED, mesh=two,
                               mode="tiles", engine="pallas")
    report(f"cornell {MC_SIZE}x{MC_SIZE}, megakernel tiles", tiles, single)
    if not tiles["kernel_launches"].get("mega_path"):
        raise RuntimeError(f"tiles: no mega_path launch in the ranks: "
                           f"{tiles['kernel_launches']}")
    if not _same(tiles, single) or tiles["total_rays"] != \
            single["total_rays"]:
        raise RuntimeError("cornell tiles: the film is not the single "
                           "device's bit for bit")
    log("cornell tiles: equal to the single-device render bit for bit, "
        f"rays {tiles['total_rays']:.0f}")

    # samples mode: the mean against the single device's at the same spp,
    # the film against the host's sum of the two ranks' launches
    samples = S.render_multichip(corn, MC_SPP, seed=MAIN_SEED, mesh=two,
                                 mode="samples", engine="pallas")
    report(f"cornell {MC_SIZE}x{MC_SIZE}, megakernel samples", samples,
           single)
    m_multi = float(samples["color"].astype(np.float64).mean())
    m_single = float(single["color"].astype(np.float64).mean())
    rel = abs(m_multi - m_single) / m_single
    bn, cfg = build_device_scene(corn)
    parts = [S.rank_chunks(bn, cfg, dev, "megakernel", MC_SPP, MAIN_SEED,
                           "samples", r, 2)[0] for r in range(2)]
    host = {k: sum(p.accum[k] for p in parts).cpu().numpy()
            for k in parts[0].accum}
    want = RD.film_result(cfg, host, None, sum(p.done for p in parts),
                          sum(p.seeds for p in parts))
    a = checks.agreement(_rows(samples, MC_SPP), _rows(want, MC_SPP))
    log(f"cornell samples: linear mean {m_multi:.7f}, one device "
        f"{m_single:.7f} (rel {rel:.3g}); against the host's sum of the "
        f"ranks' launches at the shifted seeds (bit for bit: "
        f"{_same(samples, want)}): " + json.dumps(a))
    checks.check_card(a, "cornell samples vs the ranks' launches")
    if rel > MC_MEAN_REL or samples["effective_spp"] != MC_SPP:
        raise RuntimeError(f"cornell samples: mean rel {rel}, effective "
                           f"spp {samples['effective_spp']}")
    log(f"phase 29 cornell: {time.time() - t0:.1f} s")

    # the big mesh packed 16 slots a pixel, tiles mode
    t0 = time.time()
    big = load_scene(paths["big_mesh"])
    before = os.environ.get("RENE_MEGA_PACK")
    os.environ["RENE_MEGA_PACK"] = str(MC_PACK)
    try:
        single = RD.render(big, spp=MESH_SPP, seed=MAIN_SEED, device=dev)
        tiles = S.render_multichip(big, MESH_SPP, seed=MAIN_SEED, mesh=two,
                                   mode="tiles", engine="pallas")
    finally:
        if before is None:
            os.environ.pop("RENE_MEGA_PACK")
        else:
            os.environ["RENE_MEGA_PACK"] = before
    report(f"big mesh {MESH_W}x{MESH_H} at pack {MC_PACK}, tiles", tiles,
           single)
    a = checks.agreement(_rows(tiles, MESH_SPP), _rows(single, MESH_SPP))
    log(f"big mesh tiles at pack {MC_PACK} vs one device (bit for bit: "
        f"{_same(tiles, single)}; rays {tiles['total_rays']:.0f} / "
        f"{single['total_rays']:.0f}): " + json.dumps(a))
    checks.check_card(a, "big mesh tiles")
    if not tiles["kernel_launches"].get("mega_path_mesh"):
        raise RuntimeError(f"big mesh tiles: {tiles['kernel_launches']}")
    log(f"phase 29 big mesh: {time.time() - t0:.1f} s")

    # the deep mesh through the wave engine, samples mode
    t0 = time.time()
    deep = load_scene(paths["deep_mesh"])
    single = RD.render(deep, spp=MESH_SPP, seed=MAIN_SEED, device=dev,
                       engine="wave")
    waves = S.render_multichip(deep, MESH_SPP, seed=MAIN_SEED, mesh=two,
                               mode="samples", engine="wave")
    report(f"deep mesh {MESH_W}x{MESH_H}, wave samples", waves, single)
    m_multi = float(waves["color"].astype(np.float64).mean())
    m_single = float(single["color"].astype(np.float64).mean())
    rel = abs(m_multi - m_single) / m_single
    log(f"deep mesh waves: linear mean {m_multi:.7f}, one device "
        f"{m_single:.7f} (rel {rel:.3g})")
    if rel > MC_MEAN_REL or not waves["kernel_launches"].get(
            "wave_path_mesh") or not waves["kernel_launches"].get(
            "wave_genesis"):
        raise RuntimeError(f"deep mesh waves: mean rel {rel}, launches "
                           f"{waves['kernel_launches']}")
    log(f"phase 29 deep mesh: {time.time() - t0:.1f} s")

    # the XLA engine, both modes, on the card's ranks and on CPU ranks
    t0 = time.time()
    small = load_scene(write_scene("mc_xla", scenes.cornell_box(
        MC_XLA_SIZE, MC_XLA_SIZE), SCENE_DIR))
    cpu2 = S.make_mesh(["cpu", "cpu"])
    # two NCCL ranks on the card, refused, beside these untimed renders
    refused_nccl = _refused_nccl()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(4) as ex:     # the four at once: not timed
        runs = {(mode, m.devices[0].type): ex.submit(
            S.render_multichip, small, MC_XLA_SPP, seed=XLA_SEED, mesh=m,
            mode=mode, engine="xla")
            for mode in ("samples", "tiles") for m in (two, cpu2)}
        runs = {k: f.result() for k, f in runs.items()}
    for mode in ("samples", "tiles"):
        card_out, cpu_out = runs[mode, "cuda"], runs[mode, "cpu"]
        a = checks.agreement(_rows(card_out, card_out["effective_spp"]),
                             _rows(cpu_out, cpu_out["effective_spp"]))
        log(f"XLA engine {mode}, cornell {MC_XLA_SIZE}x{MC_XLA_SIZE} x "
            f"{MC_XLA_SPP} spp, card ranks vs CPU ranks, the four renders at "
            f"once (wall {card_out['wall_time']:.3f} / "
            f"{cpu_out['wall_time']:.3f} s; rays {card_out['total_rays']:.0f} / "
            f"{cpu_out['total_rays']:.0f}): " + json.dumps(a))
        checks.check_card(a, f"XLA engine {mode}, card vs CPU ranks")
        if card_out["effective_spp"] != cpu_out["effective_spp"]:
            raise RuntimeError(f"XLA {mode}: effective spp differ")
    log(f"phase 29 XLA engine: {time.time() - t0:.1f} s")

    # one rank over NCCL; two ranks on one card over NCCL
    t0 = time.time()
    one = S.make_mesh([dev])
    corn_small = load_scene(os.path.join(SCENE_DIR, "mc_xla.pbrt"))
    nccl = S.render_multichip(corn_small, MC_XLA_SPP, seed=MAIN_SEED,
                              mesh=one, mode="tiles", engine="pallas")
    single = RD.render(corn_small, spp=MC_XLA_SPP, seed=MAIN_SEED,
                       device=dev)
    report("cornell, one rank", nccl, single)
    if nccl["backend"] != "nccl" or not _same(nccl, single):
        raise RuntimeError("one NCCL rank: not the single device's film")
    rc, msg = refused_nccl()
    log(f"two ranks on one card over NCCL: exit {rc}, {msg!r}")
    if not rc or not any("Duplicate GPU" in m or "NCCL error" in m
                         for m in msg):
        raise RuntimeError(f"two ranks on one card over NCCL: not refused "
                           f"by NCCL (exit {rc}, {msg!r})")
    log(f"phase 29 NCCL: {time.time() - t0:.1f} s")

    # the CLI: --devices 2 on this one card; --dump-module
    t0 = time.time()
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    grab = Grab()
    logging.getLogger("rene_tpu_torch").addHandler(grab)
    try:
        scene_path = os.path.join(SCENE_DIR, "mc_xla.pbrt")
        rc = cli.main([scene_path, "--devices", "2", "--spp", "1"])
        n = torch.cuda.device_count()
        want = f"--devices 2 requested but only {n} present"
        if n < 2 and (rc != 1 or want not in records):
            raise RuntimeError(f"--devices 2: exit {rc}, {records[-3:]}")
        log(f"--devices 2 on {n} card(s): exit {rc}, {want!r}")
        buf = io.StringIO()
        t = time.time()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([scene_path, "--dump-module"])
        text = buf.getvalue()
        entries = re.findall(r"^\.visible \.entry (\S+)\(", text, re.M)
        if rc != 0 or ".target sm_90a" not in text or not entries:
            raise RuntimeError(f"--dump-module: exit {rc}, "
                               f"{len(text)} characters")
        log(f"--dump-module (cornell, mega_path): {len(text)} characters of "
            f"PTX, {len(entries)} entries, {time.time() - t:.1f} s")
    finally:
        logging.getLogger("rene_tpu_torch").removeHandler(grab)
    log(f"phase 29 CLI: {time.time() - t0:.1f} s")


def training(dev, card):
    """Phase 30: the denoiser's trainer on the card (models/
    train_denoiser.py), its step-0 gradients against the CPU's, and its
    weights through the CLI."""
    import numpy as np
    import torch
    from rene_tpu_torch import scenes
    from rene_tpu_torch.models import denoise as D
    from rene_tpu_torch.models import train_denoiser as T

    t0 = time.time()
    box = write_scene("train_cornell", scenes.cornell_box(16, 16),
                      SCENE_DIR)
    t = time.time()
    rendered = T.render_pairs(box, TRAIN_NOISY, TRAIN_CLEAN, res=TRAIN_RES,
                              device=dev)
    render_s = time.time() - t
    t = time.time()
    syn = T.synthetic_pairs(TRAIN_SYNTHETIC, device=dev)
    data = tuple(np.concatenate([a, b]) for a, b in zip(rendered, syn))
    log(f"training data: {rendered[0].shape[0]} patches of the Cornell box "
        f"at {TRAIN_RES}x{TRAIN_RES} (noisy {list(TRAIN_NOISY)} spp, clean "
        f"{TRAIN_CLEAN}) in {render_s:.1f} s, {syn[0].shape[0]} synthetic "
        f"in {time.time() - t:.1f} s")

    # the step-0 gradients on the card against the CPU's, from the same
    # weights (a drawn head, so that every leaf's gradient is nonzero)
    cpu = D.UNetDenoiser(TRAIN_FEATURES, device="cpu").init(TRAIN_SEED)
    with torch.no_grad():
        g = torch.Generator().manual_seed(TRAIN_SEED)
        cpu.net.head.weight.copy_(torch.randn(
            cpu.net.head.weight.shape, generator=g) * 0.05)
    on_card = D.UNetDenoiser(TRAIN_FEATURES, device=dev)
    on_card.net.load_state_dict(cpu.net.state_dict())
    idx = np.random.default_rng(TRAIN_SEED).integers(0, data[0].shape[0],
                                                     size=8)
    grads = {}
    for net in (cpu, on_card):
        d = net.device
        batch = tuple(torch.from_numpy(a[idx]).to(d) for a in data)
        with D._full_float32():
            T.batch_loss(net, batch, torch.arange(8, device=d)).backward()
        grads[d.type] = {n: p.grad.cpu() for n, p in
                         net.net.named_parameters()}
    worst = max(float((grads["cuda"][n] - g_).abs().max()
                      / g_.abs().max()) for n, g_ in grads["cpu"].items())
    log(f"step-0 gradients, card vs CPU: largest difference "
        f"{worst:.3g} of a leaf's largest |g| (limit {TRAIN_GRAD_TOL})")
    if not worst <= TRAIN_GRAD_TOL:
        raise RuntimeError("step-0 gradients: the card is not the CPU")

    # CUDA events at the start and after every half of the steps (the
    # trainer's progress calls): the second half's ms a step leaves out
    # the first steps' set-up (cuDNN's choice of algorithms)
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()

    def mark(msg):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    net, losses = T.train(data, steps=TRAIN_STEPS,
                          features=TRAIN_FEATURES, seed=TRAIN_SEED,
                          log_every=TRAIN_STEPS // 2, progress=mark,
                          device=dev)
    events[-1].synchronize()
    ms = events[0].elapsed_time(events[-1]) / TRAIN_STEPS
    ms_late = events[1].elapsed_time(events[2]) / (TRAIN_STEPS // 2)
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    log(f"train: {TRAIN_STEPS} steps at {TRAIN_FEATURES} features, batch "
        f"8, on {data[0].shape[0]} patches: {ms:.3f} ms a step (CUDA "
        f"events), {ms_late:.3f} over the second half, loss {first:.5f} (first ten) -> {last:.5f} (last ten), "
        f"{last / first:.3f}x [{card}]")
    if not last < TRAIN_FALL * first or not np.isfinite(losses).all():
        raise RuntimeError(f"train: the loss did not fall below "
                           f"{TRAIN_FALL}x ({first} -> {last})")
    weights = os.path.join(SCENE_DIR, "trained_unet.msgpack")
    net.save(weights)
    _, l_w, r_w = cli_path("train_cornell_denoised",
                           scenes.cornell_box(TRAIN_RES, TRAIN_RES), 16,
                           (TRAIN_RES, TRAIN_RES), "cornell, trained U-Net",
                           extra=["--denoiser", "cnn", "--unet-weights",
                                  weights])
    if not any(m.startswith("denoise (cnn)") for m in r_w["records"]):
        raise RuntimeError("the CLI did not run the trained U-Net")
    log(f"phase 30, the trainer: {time.time() - t0:.1f} s")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from rene_tpu_torch import checks, kernels, scenes
    from rene_tpu_torch.integrators import mega_path as M
    from rene_tpu_torch.integrators import wave as WV
    from rene_tpu_torch.ops import texture as TX
    from rene_tpu_torch.scene import pack as P

    os.makedirs(OUT_DIR, exist_ok=True)
    os.makedirs(SCENE_DIR, exist_ok=True)
    dev = torch.device("cuda", 0)
    t_smoke = time.time()
    t_phase = [t_smoke]

    def phase_done(which):
        now = time.time()
        log(f"phase {which}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    # 1. the card
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # 2. build, every variant at once; per library its seconds and per
    # kernel its registers, spills and static shared memory (the
    # immediates' cast rows come on top as dynamic shared memory, up to
    # kernels.IMM_SMEM_MAX)
    t0 = time.time()
    sos = kernels.build(verbose=True)
    log(f"build: {time.time() - t0:.1f} s -> "
        + ", ".join(os.path.relpath(so, ROOT) for so in sos.values()))
    for name in sos:
        log(f"ptxas {name} ({kernels.build_seconds.get(name, 0.0):.1f} s): "
            + "; ".join(f"{fn} {r} registers, {ss} / {sl} bytes spill "
                        f"stores / loads, {sm} bytes smem"
                        for fn, r, ss, sl, sm in kernels.ptxas_summary(
                            kernels.ptxas.get(name, ""))))

    def compare(tabs, seed, spp, what, lanes=None):
        """The kernel and its plain version on the same tables and seed,
        held to the card's limits; the plain version on the lane ids
        `lanes` alone when given. Returns the
        agreement, with the plain version's seconds and its ray-cast tests
        and texel fetches per ray."""
        out_k = kernels.mega_path(tabs, seed, spp)
        torch.cuda.synchronize()
        reset_counts()
        t = time.time()
        out_p = M.path_lanes_ref(tabs, seed, spp, lanes=lanes)
        torch.cuda.synchronize()
        plain_s = time.time() - t
        if not bool(torch.isfinite(out_k).all()):
            raise RuntimeError(f"{what}: kernel output is not finite")
        if lanes is not None:
            out_k = out_k.index_select(1, lanes)
        a = checks.agreement(out_k, out_p)
        log(f"kernel vs plain ({what}, seed {seed}, "
            + (f"{lanes.numel()} sampled lanes, " if lanes is not None
               else "")
            + f"plain {plain_s:.1f} s): " + json.dumps(a))
        checks.check_card(a, what)
        a["plain_s"] = plain_s
        # the plain side's counts per ray of its own
        a["tests"] = {k: v / a["rays_ref"] for k, v in plain_counts().items()}
        return a

    def compare_packs(tabs, seed, what, packs):
        """The kernel's one-sample launches at each of `packs` held to the
        card's limits against the plain version on a strided sample of
        ~SAMPLE_LANES (pixel, slot) lanes of each, the samples of all the
        packs walked at once. Returns {pack: agreement}, each with the
        walk's seconds and its ray-cast tests per ray."""
        sets = []
        for p in packs:
            n_l = tabs["width"] * tabs["height"] * p
            lanes = torch.arange(0, n_l, max(1, n_l // SAMPLE_LANES),
                                 device=dev)
            out = kernels.mega_path(tabs, seed, 1, pack=p)
            if not bool(torch.isfinite(out).all()):
                raise RuntimeError(f"{what}, pack {p}: kernel output is "
                                   f"not finite")
            sets.append((p, lanes, out.index_select(1, lanes)))
            del out
        torch.cuda.synchronize()
        reset_counts()
        t = time.time()
        ref = M.path_lanes_ref(
            tabs, seed, 1, lanes=torch.cat([l for _, l, _ in sets]),
            pack=torch.cat([torch.full_like(l, p) for p, l, _ in sets]))
        torch.cuda.synchronize()
        plain_s = time.time() - t
        per_ray = {k: v / float(ref[9].sum(dtype=torch.float64))
                   for k, v in plain_counts().items()}
        res, i = {}, 0
        for p, lanes, out_k in sets:
            a = checks.agreement(out_k, ref[:, i:i + lanes.numel()])
            i += lanes.numel()
            log(f"kernel vs plain ({what}, pack {p}, seed {seed}, "
                f"{lanes.numel()} sampled lanes; one plain walk of "
                f"{ref.shape[1]} lanes at packs {list(packs)}, {plain_s:.1f}"
                f" s): " + json.dumps(a))
            checks.check_card(a, f"{what}, pack {p}")
            res[p] = dict(a, plain_s=plain_s, tests=per_ray,
                          sampled=lanes.numel())
        return res

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

    def chunk_seed(seed=MAIN_SEED):
        # the seed render.py draws for the first chunk
        return int(np.random.default_rng(seed).integers(
            0, 2 ** 31, dtype=np.int32))

    def mega_bound(tabs, per_ray=None, pack=1):
        """Bound of one megakernel launch of one sample per lane over the
        film of `tabs` at `pack` slots per pixel; `per_ray` are the plain
        walk's tests and texels per ray, scaled here by the rays of the
        launch."""
        rays = float(kernels.mega_path(tabs, 11, 1, pack=pack)[9].sum())
        tests = {k: v * rays for k, v in (per_ray or {}).items()}
        n_lanes = tabs["width"] * tabs["height"] * pack
        return bound(moved_bytes(tabs, tests) + 10 * 4 * n_lanes,
                     cast_ops(tabs, rays, tests))

    def k2_launch(run, seed, step, what, mean=False):
        """K2 launch `step` of the main path's wave of `run` over the whole
        state, timed (CUDA events, the state's copy taken off), held
        against the plain version on a strided sample of the launch's
        alive lanes; its max_abs_err is that of the radiance rows (a lane
        one side parks holds DEAD_ORIGIN in its origin rows). `mean`: the
        sample's radiance means are held within the card's limit too. The
        bound's ray-cast tests are the plain walk's on the sample, scaled
        by the rays of the whole launch."""
        k = WV.SCHEDULE[min(step, len(WV.SCHEDULE) - 1)]
        s0, n_run = wave_at(run, seed, run.samples_per_wave, step)
        alive = torch.nonzero(s0[WV.WROW_ALIVE, :n_run] > 0.5).squeeze(1)
        idx = alive[::max(1, alive.numel() // SAMPLE_LANES)]
        s_k = kernels.wave_path(run.tabs, s0.clone(), seed, step, k, n_run,
                                run.key_bounds, 1, 0)
        sub = s0.index_select(1, idx)
        torch.cuda.synchronize()
        reset_counts()
        t = time.time()
        s_p = WV.wave_step_ref(run.tabs, sub.clone(), seed, step, k,
                               idx.numel(), run.key_bounds, 1, 0)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t) * 1e3
        tests = plain_counts()
        s_ks = s_k.index_select(1, idx)
        share, key_share = lane_agreement(s_ks, s_p)
        err = float((s_ks - s_p)[WV.WROW_R:WV.WROW_R + 3].abs().max())
        m_k, m_p = (float(x[WV.WROW_R:WV.WROW_R + 3].double().mean())
                    for x in (s_ks, s_p))
        mean_rel = abs(m_k - m_p) / max(abs(m_p), 1e-12)
        ms = time_ms(lambda r=0: kernels.wave_path(
            run.tabs, s0.clone(), seed, step, k, n_run, run.key_bounds, 1,
            0), 5) \
            - time_ms(lambda r=0: s0.clone(), 5)
        rays = float((s_k[WV.WROW_RAYS] - s0[WV.WROW_RAYS]).sum())
        rays_s = float((s_p[WV.WROW_RAYS] - sub[WV.WROW_RAYS]).sum())
        tests = {key: v * rays / rays_s for key, v in tests.items()}
        rows = K2_VOL_ROWS if run.tabs["volpath"] else K2_ROWS
        bnd = bound(moved_bytes(run.tabs, tests) + n_run * 4
                    + alive.numel() * rows * 4,
                    cast_ops(run.tabs, rays, tests))
        log(f"K2 launch {step} vs plain ({what}, k {k}, {n_run} lanes run, "
            f"{alive.numel()} alive, {idx.numel()} sampled): lanes agree "
            f"{share:.5f}, keys {key_share:.5f}, radiance max abs "
            f"{err:.3g}, means {m_k!r} / {m_p!r} ({mean_rel:.2e}); kernel "
            f"{ms:.3f} ms over the whole state, plain {plain_ms:.1f} ms on "
            f"the sample, bound {bnd[0]:.4f} ms ({bnd[1]}; {rays:.0f} rays, "
            f"plain walk tests and texels {json.dumps(tests)}) [{card}]")
        if min(share, key_share) < checks.CARD_FRAC \
                or (mean and mean_rel > checks.CARD_MEAN_REL):
            raise RuntimeError(f"K2 launch {step} ({what}) disagrees with "
                               f"its plain version")
        return {"ms": ms, "plain_ms": plain_ms, "bound": bnd, "err": err,
                "sampled": idx.numel(), "k": k}

    def walk_check(tabs):
        """The mesh walk alone (phase 8): the ray-cast probe of the mesh
        build on the rays the plain version casts on ~SAMPLE_LANES
        sampled pixels (1 spp, maxdepth 4: camera, bounce and shadow
        rays), held to the plain walk on the card. Its g++ build meets
        the plain walk bit for bit (tests/test_torch_walk.py); the card's
        contracts the triangle test's sums into FMAs, so here it is held
        by phase 8's rule: a ray agrees where part, row and hit flag are
        equal and t within the radiance tolerance of rene_tpu_torch.checks
        (RAD_ATOL + RAD_RTOL |t|), on >= CARD_FRAC of the rays."""
        from rene_tpu_torch.ops.intersect import CAST_CLOSEST, cast_ref
        from rene_tpu_torch.probe import walk_rays
        t0 = time.time()
        kinds = walk_rays(tabs, dev)
        rays = torch.cat([kinds["closest"], kinds["shadow"]])
        record_s = time.time() - t0
        out_k = kernels.cast_probe(tabs, rays)
        torch.cuda.synchronize()
        t0 = time.time()
        ref = cast_ref(tabs, rays)
        torch.cuda.synchronize()
        plain_s = time.time() - t0
        closest = rays[:, 8] == CAST_CLOSEST
        ids = (out_k[:, 1:] == ref[:, 1:]).all(1)
        hit = ids & closest & (ref[:, 3] > 0)
        dt = (out_k[:, 0] - ref[:, 0]).abs()
        same = (ids & (~hit | (dt <= checks.RAD_ATOL + checks.RAD_RTOL
                                * ref[:, 0].abs()))).double().mean().item()
        t_rel = (dt[hit] / ref[hit, 0].abs().clamp_min(1e-6)).max().item()
        t_bits = (out_k[hit, 0] == ref[hit, 0]).double().mean().item()
        ms = time_ms(lambda r=0: kernels.cast_probe(tabs, rays), 5)
        log(f"walk vs plain (big mesh, {rays.shape[0]} rays: "
            f"{int(closest.sum())} closest, {int((~closest).sum())} shadow; "
            f"recorded in {record_s:.1f} s, plain {plain_s:.1f} s): rays "
            f"agree {same:.6f}; of the hits with equal part and row, t bit "
            f"for bit {t_bits:.6f}, max rel {t_rel:.2e}; probe {ms:.4f} ms, "
            f"{rays.shape[0] / ms / 1e3:.1f} Mrays/s [{card}]")
        if same < checks.CARD_FRAC:
            raise RuntimeError("the mesh walk disagrees with the plain walk")

    def tex_check(tabs, fetches):
        """The texture fetch alone (phase 15): the texture-fetch probe of
        the mesh build on the fetches the plain version made in phase 15's
        walk (ops/texture.py fetch_log: material slots and the background),
        held to the plain fetch on the card bit for bit: the fetch rounds
        every product and sum on its own, as the plain version does."""
        rows = fetches[:, :TX.TEXP_W].contiguous()
        out_k = kernels.tex_probe(tabs, rows)
        torch.cuda.synchronize()
        t0 = time.time()
        ref = TX.fetch_rows_ref(tabs["atlas"], rows)
        torch.cuda.synchronize()
        plain_s = time.time() - t0
        same = (out_k.view(torch.int32) == ref.view(torch.int32)).all(1)
        share = same.double().mean().item()
        kinds = torch.bincount(fetches[:, TX.TEXP_W].long(),
                               minlength=P.N_TEX_CLASSES + 1).tolist()
        big = rows.repeat(max(1, -(-(1 << 22) // rows.shape[0])), 1)
        ms = time_ms(lambda r=0: kernels.tex_probe(tabs, big), 5)
        log(f"fetch vs plain (textured mesh, {rows.shape[0]} fetches of "
            f"phase 15's plain walk, by class {P.IMG_CLASSES} and the "
            f"background: {kinds}; plain {plain_s:.2f} s): bit for bit "
            f"{share:.6f}; probe {ms:.4f} ms for {big.shape[0]} fetches, "
            f"{big.shape[0] / ms / 1e3:.1f} Mfetches/s [{card}]")
        if share < 1.0:
            raise RuntimeError("the texture fetch disagrees with the plain "
                               "fetch")

    phase_done("1-2")

    # 3. K1a kernel vs plain on the card
    tabs = tables_for(
        write_scene("materials", scenes.materials_scene(128, 64)), dev)
    a_mat = compare(tabs, 1234567, 4, "materials 128x64 x 4 spp")

    phase_done(3)

    # 4. the K1a main path through the CLI
    scene_path, l_k1a, r_k1a = cli_path(
        "cornell", scenes.cornell_box(1024, 1024), MAIN_SPP, (1024, 1024),
        "cornell 1024x1024", engine="pallas")
    if l_k1a["mega_path"] <= 0 or sum(l_k1a.values()) != l_k1a["mega_path"]:
        raise RuntimeError(f"the K1a main path launched {l_k1a}")

    phase_done(4)

    # 5. that path's launch vs plain, then timing at a 1-spp chunk
    tabs = tables_for(scene_path, dev)
    a_main = compare(tabs, chunk_seed(), MAIN_SPP,
                     f"cornell 1024x1024 x {MAIN_SPP} spp")
    k1a_ms = time_ms(lambda r=0: kernels.mega_path(tabs, 11 + r, 1), 20)
    k1a_plain_ms = time_ms(lambda r=0: M.path_lanes_ref(tabs, 11 + r, 1), 2)
    k1a_bound = mega_bound(tabs)
    log(f"timing (cornell 1024x1024, 1 spp): kernel {k1a_ms:.3f} ms, "
        f"plain {k1a_plain_ms:.1f} ms, bound {k1a_bound[0]:.4f} ms "
        f"({k1a_bound[1]}) [{card}]")
    del tabs
    phase_done(5)

    # 6. the mesh variant vs plain on the card
    a_mesh = []
    for name, src in (
            ("mesh_materials", scenes.mesh_materials_scene(128, 64)),
            ("instanced", scenes.instanced_scene(128, 64)),
            ("sphere_light", scenes.sphere_light_scene(128, 64, 100, 24))):
        tabs = tables_for(write_scene(name, src), dev)
        if kernels.variant(tabs) != "mega_path_mesh":
            raise RuntimeError(f"{name}: not a mesh-variant scene")
        a_mesh.append(compare(tabs, 1234567, SMALL_MESH_SPP,
                              f"{name} 128x64 x {SMALL_MESH_SPP} spp"))
    phase_done(6)

    # 7. the mesh main path through the CLI
    t0 = time.time()
    src = scenes.big_mesh_scene(MESH_W, MESH_H)
    log(f"big_mesh_scene text: {len(src) / 1e6:.1f} MB in "
        f"{time.time() - t0:.2f} s")
    scene_path, l_mesh, r_big = cli_path(
        "big_mesh", src, MESH_SPP, (MESH_W, MESH_H),
        f"big mesh {MESH_W}x{MESH_H}", engine="pallas")
    if l_mesh["mega_path_mesh"] <= 0 \
            or sum(l_mesh.values()) != l_mesh["mega_path_mesh"]:
        raise RuntimeError(f"the mesh main path launched {l_mesh}")

    phase_done(7)

    # 8. that path's launch shape vs plain, then timing
    t0 = time.time()
    tabs = tables_for(scene_path, dev)
    log(f"big mesh tables: {time.time() - t0:.2f} s, "
        f"{tabs['mesh'].shape[0]} mesh triangles, {tabs['nodes'].shape[0]} "
        f"nodes, {tabs['insts'].shape[0]} instances, BVH depth "
        f"{tabs['bvh_depth']}")
    n_pix = MESH_W * MESH_H
    pix = torch.arange(0, n_pix, max(1, n_pix // SAMPLE_LANES), device=dev)
    # with the packed launches of phase 25, in one plain walk
    k1f_checks = {"mega_path_mesh": compare_packs(
        dict(tabs, max_depth=BIG_MESH_CHECK_DEPTH), chunk_seed(),
        f"big mesh {MESH_W}x{MESH_H} x 1 sample per lane, maxdepth "
        f"{BIG_MESH_CHECK_DEPTH}", (1,) + PATH_PACKS)}
    a_big = k1f_checks["mega_path_mesh"].pop(1)
    mesh_ms = time_ms(lambda r=0: kernels.mega_path(tabs, 11 + r, 1), 10)
    mesh_plain_ms = a_big["plain_s"] * 1e3
    mesh_bound = mega_bound(tabs, a_big["tests"])
    log(f"timing (big mesh {MESH_W}x{MESH_H}, 1 spp): kernel {mesh_ms:.3f} "
        f"ms, plain {mesh_plain_ms:.1f} ms on {pix.numel()} sampled lanes "
        f"and those of packs {list(PATH_PACKS)} at maxdepth "
        f"{BIG_MESH_CHECK_DEPTH}, bound {mesh_bound[0]:.4f} ms "
        f"({mesh_bound[1]}; plain walk tests per ray "
        f"{json.dumps(a_big['tests'])}) "
        f"[{card}]")
    walk_check(tabs)
    del tabs
    phase_done(8)

    # 9. the wave kernels' registers and spills, and K2's path floors
    for name in ("wave_path", "wave_path_mesh"):
        lines = [ln.strip() for ln in kernels.ptxas.get(name, "").splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        log(f"ptxas {name}: " + " | ".join(lines))
    floors = re.search(r"#define PATH_MIN_BLOCKS \(MEGA_MESH \? (\d+) : "
                       r"(\d+)\)", (kernels.CSRC / "wave.cu").read_text())
    log(f"K2 path floors (blocks of 128 threads per SM): wave_path_mesh "
        f"{floors.group(1)}, wave_path {floors.group(2)}")

    # 10. whole waves of the kernels vs their plain versions, 128x64 x spw 4
    a_wave = {}
    for name, src in (
            ("materials", scenes.materials_scene(128, 64)),
            ("mesh_materials", scenes.mesh_materials_scene(128, 64)),
            ("instanced", scenes.instanced_scene(128, 64))):
        bn, cfg = buffers_for(write_scene(name, src))
        card_run = WV.make_wave_fn(bn, cfg, dev, samples_per_wave=4)
        dma_run = WV.make_wave_fn(bn, cfg, dev, samples_per_wave=4,
                                  sort_mode="dma")
        with plain_wave_kernels():
            plain_run = WV.make_wave_fn(bn, cfg, dev, samples_per_wave=4)
            t = time.time()
            ref = plain_run(1234567, 4)
            plain_s = time.time() - t
        out = card_run(1234567, 4)
        out_dma = dma_run(1234567, 4)
        a = checks.agreement(film(out), film(ref))
        log(f"wave vs plain ({name} 128x64 x spw 4, plain {plain_s:.1f} s, "
            f"rays {out['rays']:.0f} vs {ref['rays']:.0f}): {json.dumps(a)}")
        checks.check_card(a, f"{name} 128x64 x spw 4 wave")
        d = film_rel(out_dma, out)
        log(f"  dma vs gather film: relative {d:.3g}, rays "
            f"{out_dma['rays']:.0f} vs {out['rays']:.0f}")
        if d > 1e-4 or out_dma["rays"] != out["rays"]:
            raise RuntimeError(f"{name}: the dma wave differs from gather")
        a_wave[name] = a
        if name == "materials":
            # one K2 launch of the immediates variant at this shape
            k2_mat = k2_launch(card_run, 5, 0, "materials 128x64 x spw 4")

    phase_done("9-10")

    # 11. the wave main path through the CLI, then the megakernel on the
    # same scene and the K2 immediates variant on the Cornell box
    deep_src = scenes.big_mesh_scene(MESH_W, MESH_H, maxdepth=DEEP_DEPTH)
    deep_path, l_wave, r_wave = cli_path(
        "deep_mesh", deep_src, MESH_SPP, (MESH_W, MESH_H),
        f"deep mesh {MESH_W}x{MESH_H}, maxdepth {DEEP_DEPTH}",
        engine="wave")
    if l_wave["wave_genesis"] < 1 or l_wave["wave_path_mesh"] < 1 \
            or l_wave["mega_path"] or l_wave["mega_path_mesh"]:
        raise RuntimeError(f"the wave main path launched {l_wave}")
    r_wave2 = cli_path("deep_mesh", deep_src, MESH_SPP, (MESH_W, MESH_H),
                       f"deep mesh {MESH_W}x{MESH_H}", engine="wave",
                       seed=MAIN_SEED + 1)[2]
    r_mega = [cli_path("deep_mesh", deep_src, MESH_SPP, (MESH_W, MESH_H),
                       f"deep mesh {MESH_W}x{MESH_H}", engine="pallas",
                       seed=s)[2] for s in (MAIN_SEED, MAIN_SEED + 1)]

    def rel(a, b):
        return abs(a["mean"] - b["mean"]) / b["mean"]

    log(f"deep mesh image means: wave {r_wave['mean']:.4f} / "
        f"{r_wave2['mean']:.4f}, megakernel {r_mega[0]['mean']:.4f} / "
        f"{r_mega[1]['mean']:.4f} (seeds {MAIN_SEED} / {MAIN_SEED + 1}): "
        f"wave vs megakernel {rel(r_wave, r_mega[0]):.2e} / "
        f"{rel(r_wave2, r_mega[1]):.2e}, seed vs seed wave "
        f"{rel(r_wave2, r_wave):.2e}, megakernel "
        f"{rel(r_mega[1], r_mega[0]):.2e} (limit {MEAN_REL}); Mrays/s wave "
        f"{r_wave['rate']:.1f} / {r_wave2['rate']:.1f}, megakernel "
        f"{r_mega[0]['rate']:.1f} / {r_mega[1]['rate']:.1f} [{card}]")
    if max(rel(r_wave, r_mega[0]), rel(r_wave2, r_mega[1])) > MEAN_REL:
        raise RuntimeError("the wave and megakernel images differ")
    _, l_cw, r_cw = cli_path("cornell", scenes.cornell_box(1024, 1024),
                          MESH_SPP, (1024, 1024), "cornell 1024x1024",
                          engine="wave")
    if l_cw["wave_path"] < 1 or l_cw["wave_path_mesh"] \
            or l_cw["mega_path"] or l_cw["mega_path_mesh"]:
        raise RuntimeError(f"the Cornell wave path launched {l_cw}")

    phase_done(11)

    # 12. full-shape checks and timing on the deep scene (and K2 on the
    # Cornell box)
    bn, cfg = buffers_for(deep_path)
    run = WV.make_wave_fn(bn, cfg, dev, spp_hint=MESH_SPP)
    spw, n_pad, tabs = run.samples_per_wave, run.n_pad, run.tabs
    ns = n_pad // WV.W_SLICE
    npix = MESH_W * MESH_H
    log(f"deep wave: spw {spw}, {n_pad} lanes, state "
        f"{WV.W_NROWS * 4 * n_pad / 1e9:.2f} GB")
    seed = chunk_seed()
    s_k = run.init_state(seed, spw)
    s_p = WV.genesis_ref(tabs["cam_f"], run.pxf, run.pyf, MESH_W, npix,
                         run.n_real, seed, 1, 0)
    int_eq = (s_k[WV.WROW_ALIVE:WV.WROW_KEY] == s_p[WV.WROW_ALIVE:
                                                    WV.WROW_KEY]).all()
    k3_err = float((s_k[:WV.WROW_ALIVE] - s_p[:WV.WROW_ALIVE]).abs().max())
    key_diff = int((s_k[WV.WROW_KEY].view(torch.int32)
                    != s_p[WV.WROW_KEY].view(torch.int32)).sum())
    log(f"K3 vs plain ({MESH_W}x{MESH_H} x spw {spw}): lane rows equal "
        f"{bool(int_eq)}, ray rows max abs {k3_err:.3g}, keys differing "
        f"{key_diff} of {n_pad}")
    if not bool(int_eq) or k3_err > 1e-5 or key_diff > n_pad * 1e-4:
        raise RuntimeError("K3 disagrees with its plain version")
    del s_p
    k3_ms = time_ms(lambda r=0: kernels.wave_genesis(
        tabs, run.pxf, run.pyf, run.n_real, seed + r, 1, 0), 10)
    k3_plain_ms = time_ms(lambda r=0: WV.genesis_ref(
        tabs["cam_f"], run.pxf, run.pyf, MESH_W, npix, run.n_real, seed + r,
        1, 0), 3)
    k3_bound = bound(n_pad * (8 + WV.W_NROWS * 4), n_pad * 60)

    perm = torch.randperm(ns, device=dev).to(torch.int32)
    out_k = kernels.wave_permute(s_k, perm)
    if not torch.equal(out_k, WV.permute_ref(s_k, perm)):
        raise RuntimeError("K4 disagrees with its plain version")
    del out_k
    k4_ms = time_ms(lambda r=0: kernels.wave_permute(s_k, perm), 10)
    k4_plain_ms = time_ms(lambda r=0: WV.permute_ref(s_k, perm), 5)
    rows3 = s_k[:WV.W_SORT_PAD].view(WV.W_SORT_PAD, ns, WV.W_SLICE)
    perm64 = perm.long()
    k4_lib_ms = time_ms(lambda r=0: torch.index_select(rows3, 1, perm64), 5)
    k4_bound = bound(2 * WV.W_NROWS * 4 * n_pad + 4 * ns, 0)
    log(f"timing ({MESH_W}x{MESH_H} x spw {spw}): K3 {k3_ms:.3f} ms vs "
        f"plain {k3_plain_ms:.3f}, bound {k3_bound[0]:.3f}; K4 "
        f"{k4_ms:.3f} ms vs plain {k4_plain_ms:.3f}, index_select "
        f"{k4_lib_ms:.3f} (K4 / index_select {k4_ms / k4_lib_ms:.3f}; "
        f"index_select moves the 24 rows K4 permutes, K4 all 32), bound "
        f"{k4_bound[0]:.3f} [{card}]")
    del s_k, rows3

    # K2 at the main path's first and fifth launches, on the deep mesh
    # (mesh variant) and the Cornell box (immediates variant)
    k2_deep = [k2_launch(run, seed, step, f"deep mesh {MESH_W}x{MESH_H} x "
                         f"spw {spw}") for step in (0, 4)]
    bn_c, cfg_c = buffers_for(os.path.join(OUT_DIR, "cornell.pbrt"))
    run_c = WV.make_wave_fn(bn_c, cfg_c, dev, spp_hint=MESH_SPP)
    k2_corn = [k2_launch(run_c, seed, step, f"cornell 1024x1024 x spw "
                         f"{run_c.samples_per_wave}") for step in (0, 4)]
    del run_c

    # the 16-spp wave sorted by `dma`, a path of its own, then `gather`
    # with the device time split
    dma_run = WV.make_wave_fn(bn, cfg, dev, spp_hint=MESH_SPP,
                              sort_mode="dma")
    reset_launches()
    t = time.time()
    out_dma = dma_run.read_back(dma_run.run_dev(seed, MESH_SPP))
    dma_s = time.time() - t
    l_dma = dict(kernels.launches)
    if l_dma["wave_permute"] < 1 or l_dma["wave_genesis"] != 1 \
            or l_dma["wave_path_mesh"] < 1:
        raise RuntimeError(f"the dma wave launched {l_dma}")
    split = {}
    t = time.time()
    out = run.read_back(run.run_dev(seed, MESH_SPP, split=split))
    gather_s = time.time() - t
    rel_d = film_rel(out_dma, out)
    log(f"deep wave dma vs gather: launches {json.dumps(l_dma)}, relative "
        f"{rel_d:.2e}, rays {out_dma['rays']:.0f} "
        f"vs {out['rays']:.0f}; wall {dma_s:.3f} s vs {gather_s:.3f} s; "
        f"gather split ms {json.dumps(split)} [{card}]")
    if rel_d > 1e-4 or out_dma["rays"] != out["rays"]:
        raise RuntimeError("the dma wave differs from the gather wave")
    del dma_run

    # linear radiance means of the two engines, two seeds each: their
    # estimators differ only where a throughput leaves the normal float
    # range (the wave ends such a path, the megakernel goes on)
    seed2 = chunk_seed(MAIN_SEED + 1)
    mega = M.make_mega_batch_fn(bn, cfg, dev)
    lin = {"wave": [out, run(seed2, MESH_SPP)],
           "megakernel": [mega(seed, MESH_SPP), mega(seed2, MESH_SPP)]}
    lin = {e: [float(torch.as_tensor(o["radiance"]).double().mean())
               / MESH_SPP for o in outs] for e, outs in lin.items()}
    for e, m in lin.items():
        if not all(np.isfinite(m)):
            raise RuntimeError(f"{e}: the linear mean is not finite")
    w_, m_ = lin["wave"], lin["megakernel"]
    log(f"deep mesh linear radiance means (seeds {seed} / {seed2}): wave "
        f"{w_[0]!r} / {w_[1]!r}, megakernel {m_[0]!r} / {m_[1]!r}; wave vs "
        f"megakernel {(w_[0] - m_[0]) / m_[0]:.3e} / "
        f"{(w_[1] - m_[1]) / m_[1]:.3e}, seed vs seed wave "
        f"{(w_[1] - w_[0]) / w_[0]:.3e}, megakernel "
        f"{(m_[1] - m_[0]) / m_[0]:.3e}")
    del run, mega

    # one K2 launch at 320x180 x spw 2 against plain
    bn_s, cfg_s = buffers_for(write_scene(
        "deep_mesh_320", scenes.big_mesh_scene(320, 180,
                                               maxdepth=DEEP_DEPTH)))
    small = WV.make_wave_fn(bn_s, cfg_s, dev, samples_per_wave=2)
    k2_small = k2_launch(small, seed, 0, "deep mesh 320x180 x spw 2")

    phase_done(12)

    # 13. textures in every kernel variant vs the plain versions, every
    # scene at 128x64
    a_tex = {}
    for name in scenes.TEXTURED:
        bn, cfg = buffers_for(write_scene(
            name, scenes.textured(name, SCENE_DIR, 128, 64), SCENE_DIR))
        tabs = M.device_tables(P.pack_tables(bn, cfg), dev)
        size = f"{tabs['width']}x{tabs['height']}"
        a_m = compare(tabs, 1234567, 4, f"{name} {size} x 4 spp")
        card_run = WV.make_wave_fn(bn, cfg, dev, samples_per_wave=4)
        with plain_wave_kernels():
            ref = WV.make_wave_fn(bn, cfg, dev, samples_per_wave=4)(1234567,
                                                                    4)
        out = card_run(1234567, 4)
        a_w = checks.agreement(film(out), film(ref))
        log(f"wave vs plain ({name} {size} x spw 4, rays {out['rays']:.0f} "
            f"vs {ref['rays']:.0f}): {json.dumps(a_w)}")
        checks.check_card(a_w, f"{name} {size} x spw 4 wave")
        a_tex[name] = (tabs["has_accel"], a_m["max_abs"], a_w["max_abs"])
        if tabs["has_env"] != (name in ("tex_image", "env", "env_emitter",
                                        "textured_mesh")):
            raise RuntimeError(f"{name}: has_env {tabs['has_env']}")
        if name.startswith("env"):
            # the env tables taken away: the light sampling falls back to
            # the emitters (or to none), and the image must change
            off = dict(tabs, has_env=False, **{
                k: tabs[k][:0] for k in ("env_mcdf", "env_ccdf", "env_pdf",
                                         "env_guide")})
            a_off = checks.agreement(kernels.mega_path(off, 1234567, 4),
                                     kernels.mega_path(tabs, 1234567, 4))
            log(f"env-map light sampling in use ({name}): has_env "
                f"{tabs['has_env']}, pixels equal without the env tables "
                f"{a_off['rad_frac']:.4f}")
            if a_off["rad_frac"] > 0.9:
                raise RuntimeError(f"{name}: the env tables change nothing")

    phase_done(13)

    # 14. the textured main path through the CLI, both engines
    t0 = time.time()
    tex_src = scenes.textured_mesh_scene(SCENE_DIR, MESH_W, MESH_H)
    log(f"textured_mesh_scene text and images: {len(tex_src) / 1e6:.1f} MB "
        f"of text in {time.time() - t0:.2f} s")
    tex_path, l_tex, r_tex = cli_path(
        "textured_mesh", tex_src, MESH_SPP, (MESH_W, MESH_H),
        f"textured mesh {MESH_W}x{MESH_H}", engine="auto",
        directory=SCENE_DIR)
    if l_tex["mega_path_mesh"] <= 0 \
            or sum(l_tex.values()) != l_tex["mega_path_mesh"]:
        raise RuntimeError(f"the textured main path launched {l_tex}")
    tex_deep_src = scenes.textured_mesh_scene(SCENE_DIR, MESH_W, MESH_H,
                                              maxdepth=DEEP_DEPTH)
    _, l_texw, r_texw = cli_path(
        "textured_deep_mesh", tex_deep_src, MESH_SPP, (MESH_W, MESH_H),
        f"textured mesh {MESH_W}x{MESH_H}, maxdepth {DEEP_DEPTH}",
        engine="wave", directory=SCENE_DIR)
    if l_texw["wave_genesis"] < 1 or l_texw["wave_path_mesh"] < 1 \
            or l_texw["mega_path"] or l_texw["mega_path_mesh"]:
        raise RuntimeError(f"the textured wave path launched {l_texw}")
    log(f"textured main path Mrays/s: megakernel {r_tex['rate']:.1f} "
        f"(untextured big mesh, phase 7: {r_big['rate']:.1f}), wave at "
        f"maxdepth {DEEP_DEPTH} {r_texw['rate']:.1f} (untextured deep mesh, "
        f"phase 11: {r_wave['rate']:.1f} / {r_wave2['rate']:.1f}) [{card}]")

    phase_done(14)

    # 15. that path's 1-spp megakernel launch and first K2 launch vs plain
    # on sampled lanes, timed; the deep scene's tables are the same
    # scene's at the other depth
    t0 = time.time()
    bn, cfg = buffers_for(tex_path)
    tabs = M.device_tables(P.pack_tables(bn, cfg), dev)
    log(f"textured mesh tables: {time.time() - t0:.2f} s, atlas "
        f"{tabs['atlas'].numel()} texels ({tabs['atlas'].numel() * 4 / 1e6:.1f}"
        f" MB), {tabs['mesh_uv'].shape[0]} uv rows, has_env "
        f"{tabs['has_env']}")
    TX.fetch_log = []   # the plain walk's fetches, for the probe below
    try:
        a_texm = compare(tabs, chunk_seed(), 1,
                         f"textured mesh {MESH_W}x{MESH_H} x 1 spp",
                         lanes=pix)
        fetches = torch.cat(TX.fetch_log)
    finally:
        TX.fetch_log = None
    tex_check(tabs, fetches)
    texm_ms = time_ms(lambda r=0: kernels.mega_path(tabs, 11 + r, 1), 10)
    texm_bound = mega_bound(tabs, a_texm["tests"])
    log(f"timing (textured mesh {MESH_W}x{MESH_H}, 1 spp): kernel "
        f"{texm_ms:.3f} ms (untextured big mesh, phase 8: {mesh_ms:.3f}), "
        f"plain {a_texm['plain_s'] * 1e3:.1f} ms on {pix.numel()} sampled "
        f"lanes, bound {texm_bound[0]:.4f} ms ({texm_bound[1]}; plain walk "
        f"tests and texels per ray {json.dumps(a_texm['tests'])}) [{card}]")
    del tabs
    run = WV.make_wave_fn(
        bn, dataclasses.replace(cfg, max_depth_hint=DEEP_DEPTH), dev,
        spp_hint=MESH_SPP)
    k2_tex = k2_launch(run, chunk_seed(), 0,
                       f"textured deep mesh {MESH_W}x{MESH_H} x spw "
                       f"{run.samples_per_wave}")
    log(f"K2 first launch: textured {k2_tex['ms']:.3f} ms (untextured deep "
        f"mesh, phase 12: {k2_deep[0]['ms']:.3f}) [{card}]")
    # the fifth launch (k 4, after four launches and sorts): the path lane
    # loop with texture code over several bounces
    k2_tex5 = k2_launch(run, chunk_seed(), 4,
                        f"textured deep mesh {MESH_W}x{MESH_H} x spw "
                        f"{run.samples_per_wave}")
    del run
    phase_done(15)

    # 16. the volpath body in its four variants vs the plain versions,
    # every scene at 128x64
    a_vol = {}
    for name, src, directory in (
            ("fog", scenes.fog_scene(128, 64), None),
            ("fog_env", scenes.fog_env_scene(SCENE_DIR, 128, 64), SCENE_DIR),
            ("fog_mesh_small", scenes.fog_mesh_scene(
                128, 64, maxdepth=VOL_CHECK_DEPTH, small=True), None)):
        bn, cfg = buffers_for(write_scene(name, src, directory))
        tabs = M.device_tables(P.pack_tables(bn, cfg), dev)
        want = "mega_volpath_mesh" if "mesh" in name else "mega_volpath"
        if kernels.variant(tabs) != want:
            raise RuntimeError(f"{name}: runs {kernels.variant(tabs)}")
        spp = VOL_MESH_SPP if tabs["has_accel"] else VOL_SPP
        a_m = compare(tabs, 1234567, spp, f"{name} 128x64 x {spp} spp")
        card_run = WV.make_wave_fn(bn, cfg, dev, samples_per_wave=VOL_SPP)
        with plain_wave_kernels():
            t = time.time()
            ref = WV.make_wave_fn(bn, cfg, dev, samples_per_wave=VOL_SPP)(
                1234567, VOL_SPP)
            plain_s = time.time() - t
        out = card_run(1234567, VOL_SPP)
        a_w = checks.agreement(film(out), film(ref))
        log(f"wave vs plain ({name} 128x64 x spw {VOL_SPP}, plain "
            f"{plain_s:.1f} s, rays {out['rays']:.0f} vs {ref['rays']:.0f}): "
            f"{json.dumps(a_w)}")
        checks.check_card(a_w, f"{name} 128x64 x spw {VOL_SPP} wave")
        if "mesh" in name:
            out_dma = WV.make_wave_fn(bn, cfg, dev, samples_per_wave=VOL_SPP,
                                      sort_mode="dma")(1234567, VOL_SPP)
            d = film_rel(out_dma, out)
            log(f"  dma vs gather film: relative {d:.3g}, rays "
                f"{out_dma['rays']:.0f} vs {out['rays']:.0f}")
            if d > 1e-4 or out_dma["rays"] != out["rays"]:
                raise RuntimeError(f"{name}: the dma wave differs from "
                                   f"gather")
        a_vol[name] = (tabs["has_accel"], a_m["max_abs"], a_w["max_abs"])
        if name == "fog":
            # the media table zeroed: sigma_t 0 everywhere, no scattering
            # and no attenuation, and the image must change
            off = dict(tabs, media=torch.zeros_like(tabs["media"]))
            a_off = checks.agreement(kernels.mega_path(off, 1234567, VOL_SPP),
                                     kernels.mega_path(tabs, 1234567,
                                                       VOL_SPP))
            log(f"the medium in use ({name}): pixels equal with the media "
                f"zeroed {a_off['rad_frac']:.4f}, image mean "
                f"{a_off['mean_out']:.4f} against {a_off['mean_ref']:.4f}")
            if a_off["rad_frac"] > 0.9:
                raise RuntimeError(f"{name}: the media change nothing")
        del tabs
    smoke = cornell_smoke_check(dev)

    phase_done(16)

    # 17. the volpath main path through the CLI, both engines; the
    # immediates variants on fog_scene at the same film
    fog_src = scenes.fog_mesh_scene(MESH_W, MESH_H)
    fog_path, l_fog, r_fog = cli_path(
        "fog_mesh", fog_src, MESH_SPP, (MESH_W, MESH_H),
        f"fog mesh {MESH_W}x{MESH_H}, volpath maxdepth 64", engine="auto")
    if l_fog["mega_volpath_mesh"] <= 0 \
            or sum(l_fog.values()) != l_fog["mega_volpath_mesh"]:
        raise RuntimeError(f"the volpath main path launched {l_fog}")
    _, l_fogw, r_fogw = cli_path(
        "fog_mesh", fog_src, MESH_SPP, (MESH_W, MESH_H),
        f"fog mesh {MESH_W}x{MESH_H}, volpath maxdepth 64", engine="wave")
    if l_fogw["wave_genesis"] < 1 or l_fogw["wave_volpath_mesh"] < 1 \
            or sum(l_fogw.values()) != (l_fogw["wave_genesis"]
                                        + l_fogw["wave_volpath_mesh"]):
        raise RuntimeError(f"the volpath wave path launched {l_fogw}")
    fs_path, l_fs, r_fs = cli_path(
        "fog", scenes.fog_scene(MESH_W, MESH_H), MESH_SPP, (MESH_W, MESH_H),
        f"fog {MESH_W}x{MESH_H}", engine="auto")
    if l_fs["mega_volpath"] <= 0 or sum(l_fs.values()) != l_fs["mega_volpath"]:
        raise RuntimeError(f"the fog scene launched {l_fs}")
    _, l_fsw, r_fsw = cli_path(
        "fog", scenes.fog_scene(MESH_W, MESH_H), MESH_SPP, (MESH_W, MESH_H),
        f"fog {MESH_W}x{MESH_H}", engine="wave")
    if l_fsw["wave_genesis"] < 1 or l_fsw["wave_volpath"] < 1 \
            or sum(l_fsw.values()) != (l_fsw["wave_genesis"]
                                       + l_fsw["wave_volpath"]):
        raise RuntimeError(f"the fog scene's wave launched {l_fsw}")
    log(f"volpath main path Mrays/s (nominal rays): fog mesh megakernel "
        f"{r_fog['rate']:.1f}, wave {r_fogw['rate']:.1f}; fog scene "
        f"megakernel {r_fs['rate']:.1f}, wave {r_fsw['rate']:.1f} [{card}]")

    # the two engines' linear radiance means on the fog mesh, two seeds
    bn, cfg = buffers_for(fog_path)
    seeds = (chunk_seed(), chunk_seed(MAIN_SEED + 1))
    mega = M.make_mega_batch_fn(bn, cfg, dev)
    run = WV.make_wave_fn(bn, cfg, dev, spp_hint=MESH_SPP)
    lin = {"wave": [run(s, MESH_SPP) for s in seeds],
           "megakernel": [mega(s, MESH_SPP) for s in seeds]}
    lin = {e: [float(torch.as_tensor(o["radiance"]).double().mean())
               / MESH_SPP for o in outs] for e, outs in lin.items()}
    w_, m_ = lin["wave"], lin["megakernel"]
    d_eng = [abs(w_[i] - m_[i]) / m_[i] for i in range(2)]
    log(f"fog mesh linear radiance means (seeds {seeds[0]} / {seeds[1]}): "
        f"wave {w_[0]!r} / {w_[1]!r}, megakernel {m_[0]!r} / {m_[1]!r}; "
        f"wave vs megakernel {d_eng[0]:.3e} / {d_eng[1]:.3e}, seed vs seed "
        f"wave {abs(w_[1] - w_[0]) / w_[0]:.3e}, megakernel "
        f"{abs(m_[1] - m_[0]) / m_[0]:.3e} (limit {MEAN_REL})")
    if not all(np.isfinite(w_ + m_)) or max(d_eng) > MEAN_REL:
        raise RuntimeError("the volpath wave and megakernel means differ")
    del mega

    phase_done(17)

    # 18. the 1-spp megakernel launch and the first K2 launch of the fog
    # mesh and of the fog scene vs plain on sampled lanes, timed
    def vol_launch(path, what):
        tabs = tables_for(path, dev)
        # a cluster-mode scene with the packed launches of phase 25
        res = compare_packs(
            dict(tabs, max_depth=VOL_CHECK_DEPTH), chunk_seed(),
            f"{what} {MESH_W}x{MESH_H} x 1 sample per lane, maxdepth "
            f"{VOL_CHECK_DEPTH}", (1,) + (VOL_PACKS if tabs["block_seed"]
                                          else ()))
        a = res.pop(1)
        if res:
            k1f_checks[kernels.variant(tabs)] = res
        ms = time_ms(lambda r=0: kernels.mega_path(tabs, 11 + r, 1), 10)
        rays = float(kernels.mega_path(tabs, 11, 1)[9].sum())
        bnd = mega_bound(tabs, a["tests"])
        casts = sum(a["tests"].get(k, 0.0)
                    for k in ("closest", "march", "emit_pdf"))
        log(f"timing ({what} {MESH_W}x{MESH_H}, 1 spp, maxdepth "
            f"{tabs['max_depth']}): kernel {ms:.3f} ms, {rays:.0f} nominal "
            f"rays, {ms * 1e6 / rays:.3f} ns per nominal ray; plain "
            f"{a['plain_s'] * 1e3:.1f} ms on {pix.numel()} sampled lanes (and "
            f"those of its packed launches) at maxdepth {VOL_CHECK_DEPTH}: "
            f"real casts per nominal ray "
            f"{casts:.3f} ({json.dumps(a['tests'])}); bound {bnd[0]:.4f} ms "
            f"({bnd[1]}) [{card}]")
        return {"ms": ms, "plain_ms": a["plain_s"] * 1e3, "bound": bnd,
                "err": a["max_abs"], "casts": casts, "tests": a["tests"]}

    v_fog = vol_launch(fog_path, "fog mesh")
    k2_fog = k2_launch(run, chunk_seed(), 0, f"fog mesh {MESH_W}x{MESH_H} "
                       f"x spw {run.samples_per_wave}")
    del run
    v_fs = vol_launch(fs_path, "fog")
    bn_f, cfg_f = buffers_for(fs_path)
    run = WV.make_wave_fn(bn_f, cfg_f, dev, spp_hint=MESH_SPP)
    k2_fs = k2_launch(run, chunk_seed(), 0, f"fog {MESH_W}x{MESH_H} x spw "
                      f"{run.samples_per_wave}")
    del run
    # the fifth K2 launch (k 4, after four launches and sorts, lanes
    # parking inside it) of both volpath main paths' waves cut to maxdepth
    # VOL_CHECK_DEPTH, both samplers, held against plain as phase 12 holds
    # the deep mesh's, and by the sample's radiance means
    k2_fifth = {}
    for name, src in (("fog mesh", scenes.fog_mesh_scene(
            MESH_W, MESH_H, maxdepth=VOL_CHECK_DEPTH)),
            ("fog", scenes.fog_scene(MESH_W, MESH_H))):
        for smp in ("independent", "sobol"):
            bn_5, cfg_5 = buffers_for(write_scene(
                f"{name.replace(' ', '_')}_{smp}_{VOL_CHECK_DEPTH}",
                scenes.with_sampler(src) if smp == "sobol" else src,
                SCENE_DIR))
            run = WV.make_wave_fn(bn_5, cfg_5, dev, spp_hint=MESH_SPP)
            if run.tabs["max_depth"] != VOL_CHECK_DEPTH:
                raise RuntimeError(f"{name}: maxdepth {run.tabs['max_depth']}")
            k2_fifth[name, smp] = k2_launch(
                run, chunk_seed(), 4, f"{name} {MESH_W}x{MESH_H} x spw "
                f"{run.samples_per_wave}, maxdepth {VOL_CHECK_DEPTH}, {smp}",
                mean=True)
            del run
    log(f"volpath main path: {r_fog['rate']:.1f} Mrays/s megakernel, "
        f"{r_fogw['rate']:.1f} wave (wave / megakernel "
        f"{r_fogw['rate'] / r_fog['rate']:.3f}); {v_fog['casts']:.3f} real "
        f"casts per nominal ray; 1-spp launch {v_fog['ms']:.3f} ms, first "
        f"K2 launch {k2_fog['ms']:.3f} ms [{card}]")
    smoke_ms, smoke_bound = cornell_smoke_timing(smoke, card)
    for name in ("mega_volpath", "mega_volpath_mesh", "wave_volpath",
                 "wave_volpath_mesh"):
        lines = [ln.strip() for ln in kernels.ptxas.get(name, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"ptxas {name}: " + " | ".join(lines))
    phase_done(18)

    # 19. the Sobol probe (P-r3ac): its path is one launch on 2^22 int32
    # inputs; then bit for bit against its plain version, timed
    from rene_tpu_torch.ops import rng as RNG
    from rene_tpu_torch.ops import sobol as SB
    xs = torch.randint(-2 ** 31, 2 ** 31 - 1, (PROBE_N,), dtype=torch.int32,
                       device=dev,
                       generator=torch.Generator(dev).manual_seed(3))
    reset_launches()
    out_k = kernels.sobol_probe(xs)
    torch.cuda.synchronize()
    l_probe = dict(kernels.launches)
    if l_probe["sobol_probe"] != 1 or sum(l_probe.values()) != 1:
        raise RuntimeError(f"the probe's path launched {l_probe}")
    if not torch.equal(out_k, SB.probe_ref(xs)):
        raise RuntimeError("sobol_probe disagrees with its plain version")
    probe_ms = time_ms(lambda r=0: kernels.sobol_probe(xs), 20)
    probe_plain_ms = time_ms(lambda r=0: SB.probe_ref(xs), 3)
    probe_bound = bound(PROBE_N * 4 * 8, PROBE_N * PROBE_OPS)
    log(f"sobol_probe ({PROBE_N} inputs, 7 words each): bit for bit equal; "
        f"kernel {probe_ms:.4f} ms, plain {probe_plain_ms:.3f} ms, bound "
        f"{probe_bound[0]:.4f} ms ({probe_bound[1]}) [{card}]")
    del xs, out_k
    phase_done(19)

    # 20. the Sobol instances against their plain versions on the card:
    # the megakernel and whole waves (`gather`; `dma` on the mesh) of the
    # scenes with Sampler "sobol"; the small fog mesh cut to 64x32 x 1 spp
    # at maxdepth VOL_CHECK_DEPTH (its plain walk is the slowest)
    for name, src, directory, spp, s_spw in (
            ("sobol_materials", scenes.materials_scene(128, 64), None, 4, 4),
            ("sobol_mesh_materials", scenes.mesh_materials_scene(128, 64),
             None, SMALL_MESH_SPP, 4),
            ("sobol_fog", scenes.fog_scene(128, 64), None, VOL_SPP, 4),
            ("sobol_fog_env", scenes.fog_env_scene(SCENE_DIR, 128, 64),
             SCENE_DIR, VOL_SPP, 4),
            ("sobol_fog_mesh_small", scenes.fog_mesh_scene(
                64, 32, maxdepth=VOL_CHECK_DEPTH, small=True), None, 1, 2)):
        bn, cfg = buffers_for(write_scene(name, scenes.with_sampler(src),
                                          directory))
        tabs = M.device_tables(P.pack_tables(bn, cfg), dev)
        inst = kernels.variant(tabs)
        if not inst.endswith(kernels.SOBOL):
            raise RuntimeError(f"{name}: runs {inst}")
        size = f"{tabs['width']}x{tabs['height']}"
        compare(tabs, 1234567, spp, f"{name} {size} x {spp} spp")
        a_i = checks.agreement(
            kernels.mega_path(dict(tabs, sobol=False), 1234567, spp),
            kernels.mega_path(tabs, 1234567, spp))
        if a_i["rad_frac"] > 0.9:
            raise RuntimeError(f"{name}: the Sobol instance traces the "
                               f"independent paths")
        card_run = WV.make_wave_fn(bn, cfg, dev, samples_per_wave=s_spw)
        with plain_wave_kernels():
            ref = WV.make_wave_fn(bn, cfg, dev, samples_per_wave=s_spw)(
                1234567, s_spw)
        out = card_run(1234567, s_spw)
        a_w = checks.agreement(film(out), film(ref))
        log(f"sobol wave vs plain ({name} {size} x spw {s_spw}, rays "
            f"{out['rays']:.0f} vs {ref['rays']:.0f}): {json.dumps(a_w)}; "
            f"pixels equal to the independent instance "
            f"{a_i['rad_frac']:.4f}")
        checks.check_card(a_w, f"{name} {size} x spw {s_spw} wave")
        if "mesh_materials" in name:
            out_dma = WV.make_wave_fn(bn, cfg, dev, samples_per_wave=s_spw,
                                      sort_mode="dma")(1234567, s_spw)
            d = film_rel(out_dma, out)
            log(f"  dma vs gather film: relative {d:.3g}, rays "
                f"{out_dma['rays']:.0f} vs {out['rays']:.0f}")
            if d > 1e-4 or out_dma["rays"] != out["rays"]:
                raise RuntimeError(f"{name}: the dma wave differs")
        del tabs
    phase_done(20)

    # 21. the Sobol main paths through the CLI at full width (the scenes
    # of phases 4-17 with --sampler sobol, the Cornell box with Sampler
    # "sobol" in its text), each with the launch counts set to 0 just
    # before; Mrays/s beside the independent runs of the same scenes
    def sob_cli(name, src, spp, size, what, engine, expect):
        path, l, r = cli_path(name, src, spp, size, what, engine=engine,
                              sampler="auto" if src else "sobol")
        if any(l[k] < 1 for k in expect) or sum(l.values()) != sum(
                l[k] for k in expect):
            raise RuntimeError(f"the Sobol path {what} ({engine}) launched "
                               f"{l}")
        return path, l, r

    S_ = kernels.SOBOL
    corn_s, l_s_corn, r_s_corn = sob_cli(
        "cornell_sobol", scenes.with_sampler(scenes.cornell_box(1024, 1024)),
        MAIN_SPP, (1024, 1024), "sobol cornell 1024x1024", "auto",
        ["mega_path" + S_])
    _, l_s_cw, r_s_cw = sob_cli(
        "cornell", None, MESH_SPP, (1024, 1024), "sobol cornell 1024x1024",
        "wave", ["wave_genesis" + S_, "wave_path" + S_])
    film720 = (MESH_W, MESH_H)
    _, l_s_big, r_s_big = sob_cli(
        "big_mesh", None, MESH_SPP, film720, "sobol big mesh", "auto",
        ["mega_path_mesh" + S_])
    _, l_s_bigw, r_s_bigw = sob_cli(
        "big_mesh", None, MESH_SPP, film720, "sobol big mesh", "wave",
        ["wave_genesis" + S_, "wave_path_mesh" + S_])
    r_bigw = cli_path("big_mesh", None, MESH_SPP, film720, "big mesh",
                      engine="wave")[2]
    _, l_s_fog, r_s_fog = sob_cli(
        "fog_mesh", None, MESH_SPP, film720, "sobol fog mesh", "auto",
        ["mega_volpath_mesh" + S_])
    _, l_s_fogw, r_s_fogw = sob_cli(
        "fog_mesh", None, MESH_SPP, film720, "sobol fog mesh", "wave",
        ["wave_genesis" + S_, "wave_volpath_mesh" + S_])
    _, l_s_fs, r_s_fs = sob_cli(
        "fog", None, MESH_SPP, film720, "sobol fog", "auto",
        ["mega_volpath" + S_])
    _, l_s_fsw, r_s_fsw = sob_cli(
        "fog", None, MESH_SPP, film720, "sobol fog", "wave",
        ["wave_genesis" + S_, "wave_volpath" + S_])
    log("Sobol main paths, Mrays/s sobol / independent: "
        + ", ".join(f"{w} {a['rate']:.1f} / {b['rate']:.1f}" for w, a, b in (
            ("cornell auto 64 spp", r_s_corn, r_k1a),
            ("cornell wave 16 spp", r_s_cw, r_cw),
            ("big mesh auto", r_s_big, r_big), ("big mesh wave", r_s_bigw,
                                                r_bigw),
            ("fog mesh auto", r_s_fog, r_fog), ("fog mesh wave", r_s_fogw,
                                                r_fogw),
            ("fog auto", r_s_fs, r_fs), ("fog wave", r_s_fsw, r_fsw)))
        + f" [{card}]")
    phase_done(21)

    # 22. full-shape launches: the 1-spp Sobol megakernel launch of the
    # Cornell box, the big mesh, the fog and the fog mesh, and the first
    # Sobol K2 launch of each wave main path, held against the plain
    # versions on ~131k sampled lanes (the mesh and volpath megakernel
    # launches at the maxdepth of phases 8 and 18, the mesh scenes' in
    # phase 25) and timed against their
    # independent forms on the same inputs, in turns (independent, Sobol,
    # Sobol, independent)
    def turns(fn_ind, fn_sob, reps):
        t = [time_ms(f, reps) for f in (fn_ind, fn_sob, fn_sob, fn_ind)]
        return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2

    tabs_c = tables_for(os.path.join(OUT_DIR, "cornell.pbrt"), dev)
    tabs_cs = dict(tabs_c, sobol=True)
    n_c = 1024 * 1024
    pix_c = torch.arange(0, n_c, max(1, n_c // SAMPLE_LANES), device=dev)
    a_cs = compare(tabs_cs, chunk_seed(), 1, "sobol cornell 1024x1024 x 1 "
                   "spp", lanes=pix_c)
    s_ms, i_ms = turns(lambda r=0: kernels.mega_path(tabs_c, 11 + r, 1),
                       lambda r=0: kernels.mega_path(tabs_cs, 11 + r, 1), 20)
    cs_plain_ms = time_ms(lambda r=0: M.path_lanes_ref(tabs_cs, 11 + r, 1), 2)
    cs_bound = mega_bound(tabs_cs)
    mega_s = {"mega_path" + S_: {"ms": s_ms, "ind_ms": i_ms,
                                 "plain_ms": cs_plain_ms, "bound": cs_bound,
                                 "err": a_cs["max_abs"],
                                 "shape": "cornell 1024x1024 x 1 spp",
                                 "plain_at": "the same launch"}}
    log(f"timing (sobol cornell 1024x1024, 1 spp): kernel {s_ms:.3f} ms, "
        f"independent {i_ms:.3f} ms (x{s_ms / i_ms:.3f}), plain "
        f"{cs_plain_ms:.1f} ms, bound {cs_bound[0]:.4f} ms ({cs_bound[1]}) "
        f"[{card}]")

    def k2_turns(run, seed, what):
        """k2_launch on the Sobol wave `run`, and its first launch timed
        against the independent instance on the same state."""
        a = k2_launch(run, seed, 0, what)
        s0, n_run = wave_at(run, seed, run.samples_per_wave, 0)
        tabs_i = dict(run.tabs, sobol=False)
        clone = time_ms(lambda r=0: s0.clone(), 5)
        s_t, i_t = turns(
            lambda r=0: kernels.wave_path(tabs_i, s0.clone(), seed, 0, 1,
                                          n_run, run.key_bounds, 1, 0),
            lambda r=0: kernels.wave_path(run.tabs, s0.clone(), seed, 0, 1,
                                          n_run, run.key_bounds, 1, 0), 5)
        a.update(ms=s_t - clone, ind_ms=i_t - clone, what=what)
        log(f"  K2 first launch ({what}): sobol {a['ms']:.3f} ms, "
            f"independent {a['ind_ms']:.3f} ms (x{a['ms'] / a['ind_ms']:.3f})"
            f" [{card}]")
        return a

    seed = chunk_seed()
    k2_s = {}
    for name, inst, mega in (("cornell", "wave_path", False),
                             ("big_mesh", "wave_path_mesh", True),
                             ("fog", "wave_volpath", True),
                             ("fog_mesh", "wave_volpath_mesh", True)):
        bn, cfg = buffers_for(os.path.join(OUT_DIR, name + ".pbrt"))
        run = WV.make_wave_fn(bn, dataclasses.replace(cfg, sampler="sobol"),
                              dev, spp_hint=MESH_SPP)
        k2_s[inst + S_] = k2_turns(run, seed, f"sobol {name} "
                                   f"{run.tabs['width']}x"
                                   f"{run.tabs['height']} x spw "
                                   f"{run.samples_per_wave}")
        if mega:
            # the megakernel's 1-spp launch of the same tables, on a
            # cluster-mode scene with the packed launches of phase 25 in
            # one plain walk
            tabs = run.tabs
            tabs_i = dict(tabs, sobol=False)
            depth = VOL_CHECK_DEPTH if tabs["volpath"] \
                else BIG_MESH_CHECK_DEPTH
            packs = (VOL_PACKS if tabs["volpath"] else PATH_PACKS) \
                if tabs["block_seed"] else ()
            minst = kernels.variant(tabs)
            res = compare_packs(dict(tabs, max_depth=depth), chunk_seed(),
                                f"sobol {name} {MESH_W}x{MESH_H} x 1 sample "
                                f"per lane, maxdepth {depth}", (1,) + packs)
            a_m = res.pop(1)
            if res:
                k1f_checks[minst] = res
            reps = 5 if tabs["volpath"] and tabs["has_accel"] else 10
            s_t, i_t = turns(
                lambda r=0: kernels.mega_path(tabs_i, 11 + r, 1),
                lambda r=0: kernels.mega_path(tabs, 11 + r, 1), reps)
            mega_s[minst] = {"ms": s_t, "ind_ms": i_t,
                             "plain_ms": a_m["plain_s"] * 1e3,
                             "err": a_m["max_abs"],
                             "bound": mega_bound(tabs, a_m["tests"]),
                             "shape": f"{name} {MESH_W}x{MESH_H} x 1 spp",
                             "plain_at": f"{pix.numel()} sampled lanes at "
                                         f"maxdepth {depth}"
                                         + (f", in one walk with those of "
                                            f"packs {list(packs)}" if packs
                                            else "")}
            log(f"  1-spp megakernel launch ({minst}): {s_t:.3f} ms, "
                f"independent {i_t:.3f} ms (x{s_t / i_t:.3f}) [{card}]")
        del run
    phase_done(22)

    # 23. the sampler's worth on the card: the reference's Sobol test scene
    # at 256x256, Sobol and independent at 32 spp against a 4096-spp
    # independent render (err_s < 0.85 err_i, the reference's factor);
    # the Sobol and independent Cornell linear means at 64 spp
    tabs_t = tables_for(write_scene("sobol_test", scenes.sobol_test_scene(
        SOBOL_TEST_SIZE, SOBOL_TEST_SIZE)), dev)
    ind_t = dict(tabs_t, sobol=False)
    ref_t = kernels.mega_path(ind_t, 11, SOBOL_REF_SPP)[0:3] / SOBOL_REF_SPP
    err = {k: float((kernels.mega_path(t_, 5, SOBOL_TEST_SPP)[0:3]
                     / SOBOL_TEST_SPP - ref_t).abs().mean())
           for k, t_ in (("sobol", tabs_t), ("independent", ind_t))}
    m_cs = float(kernels.mega_path(tabs_cs, seed, MAIN_SPP)[0:3].double()
                 .mean()) / MAIN_SPP
    m_ci = float(kernels.mega_path(tabs_c, seed, MAIN_SPP)[0:3].double()
                 .mean()) / MAIN_SPP
    log(f"sobol test scene {SOBOL_TEST_SIZE}x{SOBOL_TEST_SIZE}: mean abs "
        f"error at {SOBOL_TEST_SPP} spp against {SOBOL_REF_SPP} spp: sobol "
        f"{err['sobol']!r}, independent {err['independent']!r} (ratio "
        f"{err['sobol'] / err['independent']:.3f}, limit "
        f"{SOBOL_ERR_FACTOR}); cornell linear means at {MAIN_SPP} spp: "
        f"sobol {m_cs!r}, independent {m_ci!r}, relative "
        f"{abs(m_cs - m_ci) / m_ci:.3e} (limit {MEAN_REL})")
    if not err["sobol"] < SOBOL_ERR_FACTOR * err["independent"]:
        raise RuntimeError("the Sobol render is not closer to the reference")
    if not np.isfinite(m_cs) or abs(m_cs - m_ci) > MEAN_REL * m_ci:
        raise RuntimeError("the Sobol and independent means differ")
    del tabs_t, ind_t, ref_t, tabs_c, tabs_cs
    phase_done(23)

    # 24. lanes past 2^24: K3 over a 1024x1024 x spw 24 wave (25.2 M
    # lanes), independent and Sobol; lanes 2^24 .. 2^24 + 4096 read back:
    # the lane row equal to each lane's index, their initial streams
    # pairwise distinct, `want` and (through the camera rays) the Sobol
    # sample index equal to the plain version's
    bn, cfg = buffers_for(os.path.join(OUT_DIR, "cornell.pbrt"))
    lanes = torch.arange(*LANES24, device=dev)
    k3_s = {}
    for sampler in ("independent", "sobol"):
        run = WV.make_wave_fn(bn, dataclasses.replace(cfg, sampler=sampler),
                              dev, samples_per_wave=LANES24_SPW)
        state = run.init_state(seed, LANES24_SPW)
        sub = state.index_select(1, lanes)
        ids = WV.lane_ids(sub)
        st = RNG.wave_state(ids, seed, -1)
        ref = WV.genesis_ref(run.tabs["cam_f"], run.pxf[lanes],
                             run.pyf[lanes], 1024, 1024 * 1024, run.n_real,
                             seed, 1, 0, sobol=sampler == "sobol",
                             lanes=lanes)
        ids_ok = bool(torch.equal(ids, lanes))
        n_st = int(torch.unique(st).numel())
        rows_ok = bool(torch.equal(sub[WV.WROW_ALIVE:WV.WROW_KEY],
                                   ref[WV.WROW_ALIVE:WV.WROW_KEY]))
        ray_err = float((sub[:WV.WROW_ALIVE] - ref[:WV.WROW_ALIVE]).abs()
                        .max())
        ms = time_ms(lambda r=0: kernels.wave_genesis(
            run.tabs, run.pxf, run.pyf, run.n_real, seed + r, 1, 0), 5)
        k3_s[sampler] = {"ms": ms, "err": ray_err, "n_pad": run.n_pad,
                         "plain_ms": None}
        log(f"K3 past 2^24 ({sampler}, 1024x1024 x spw {LANES24_SPW}, "
            f"{run.n_pad} lanes, lanes {LANES24[0]}..{LANES24[1]}): ids "
            f"exact {ids_ok}, distinct streams {n_st} of {lanes.numel()}, "
            f"rows 12-19 equal {rows_ok}, ray rows max abs {ray_err:.3g}; "
            f"K3 {ms:.3f} ms [{card}]")
        if not (ids_ok and rows_ok and n_st == lanes.numel()
                and ray_err <= 1e-5):
            raise RuntimeError(f"K3 lanes past 2^24 ({sampler}) are wrong")
        if sampler == "sobol":
            k3_s[sampler]["plain_ms"] = time_ms(lambda r=0: WV.genesis_ref(
                run.tabs["cam_f"], run.pxf, run.pyf, 1024, 1024 * 1024,
                run.n_real, seed + r, 1, 0, sobol=True), 1)
            k3_s[sampler]["bound"] = bound(
                run.n_pad * (8 + WV.W_NROWS * 4), run.n_pad * PROBE_OPS)
        del state, sub, run
    log(f"K3 at {LANES24_SPW * 1024 * 1024} lanes: sobol "
        f"{k3_s['sobol']['ms']:.3f} ms, independent "
        f"{k3_s['independent']['ms']:.3f} ms [{card}]")
    phase_done(24)

    # 25. sample-in-tile packing (K1f): the mesh builds' packed launches,
    # independent and Sobol, held to their plain versions in phases 8, 18
    # and 22, timed; the packed main paths through the CLI with
    # RENE_MEGA_PACK; the pack sweep (rene_tpu_torch.probe.pack_sweep)
    from rene_tpu_torch import probe as PB
    from rene_tpu_torch.utils.film import read_png
    big_path = os.path.join(OUT_DIR, "big_mesh.pbrt")
    tabs_b = tables_for(big_path, dev)
    tabs_f = tables_for(fog_path, dev)
    k1f = {}
    for inst, res in k1f_checks.items():
        t = dict(tabs_f if "volpath" in inst else tabs_b,
                 sobol=inst.endswith(S_))
        depth = VOL_CHECK_DEPTH if t["volpath"] else BIG_MESH_CHECK_DEPTH
        for pack, a in res.items():
            bnd = mega_bound(t, a["tests"], pack)
            reps = 3 if t["volpath"] else 5
            ms = time_ms(lambda r=0: kernels.mega_path(t, 11 + r, 1,
                                                       pack=pack), reps)
            k1f.setdefault(inst, []).append(
                {"pack": pack, "ms": ms, "plain_ms": a["plain_s"] * 1e3,
                 "bound": bnd, "err": a["max_abs"], "sampled": a["sampled"],
                 "depth": depth, "packs": [1] + list(res)})
            log(f"timing ({inst} pack {pack} at the scene's maxdepth "
                f"{t['max_depth']}: {pack} spp delivered): kernel {ms:.3f} "
                f"ms, plain {a['plain_s'] * 1e3:.1f} ms for its walk at "
                f"maxdepth {depth} with pack 1, bound {bnd[0]:.4f} ms "
                f"({bnd[1]}) [{card}]")
    del tabs_b, tabs_f

    big_src = scenes.big_mesh_scene(MESH_W, MESH_H)
    l_pack = {}
    for name, src, pack, sampler, inst in (
            ("big_mesh_pack16", big_src, 16, "auto", "mega_path_mesh"),
            ("big_mesh_pack16", None, 16, "sobol", "mega_path_mesh" + S_),
            ("fog_mesh_pack4", fog_src, 4, "auto", "mega_volpath_mesh"),
            ("fog_mesh_pack4", None, 4, "sobol", "mega_volpath_mesh" + S_)):
        with PB.mega_pack(pack):
            _, l_p, r_p = cli_path(
                name, src, MESH_SPP, (MESH_W, MESH_H),
                f"{name} {MESH_W}x{MESH_H}, RENE_MEGA_PACK={pack}",
                engine="pallas", sampler=sampler)
        # one launch: the chunk loop runs MESH_SPP // pack per-lane samples
        if l_p[inst] != 1 or sum(l_p.values()) != 1:
            raise RuntimeError(f"{name} ({sampler}) launched {l_p}, want one "
                               f"of {inst}")
        l_pack[inst] = l_p[inst]
        if name.startswith("big_mesh") and sampler == "auto":
            # the reference's statistical checks of a packed render
            # (tests/test_pallas_cluster.py:603-630): the streams differ
            # by design
            n1, n16 = (read_png(os.path.join(OUT_DIR, f"{n}_pallas_"
                                             f"{MAIN_SEED}_normal.png"))
                       for n in ("big_mesh", name))
            d_n = float(np.abs(n1.astype(np.float64) - n16).mean()) / 128.0
            d_m = abs(r_p["mean"] - r_big["mean"]) / r_big["mean"]
            log(f"packed vs pack-1 big mesh render: image mean "
                f"{r_p['mean']:.4f} vs {r_big['mean']:.4f} (relative "
                f"{d_m:.3e}, limit 1e-2), first-hit normal mean abs "
                f"difference {d_n:.4f} (limit 0.05); Mrays/s {r_p['rate']:.1f}"
                f" vs {r_big['rate']:.1f} [{card}]")
            if not (d_m <= 1e-2 and d_n < 0.05):
                raise RuntimeError("the packed render differs from pack 1")
    sweep = PB.pack_sweep(dev, SWEEP_FILMS, PB.PACK_RUNS[:1])
    for row in sweep:
        log(f"pack sweep: {row['scene']} {row['film'][0]}x{row['film'][1]} "
            f"{row['spp']} spp pack {row['pack']} ({row['resident_sets']:.2f}"
            f" resident sets): kernel {row['kernel_ms']:.3f} ms, "
            f"{row['kernel_mrays_s']:.1f} Mrays/s; "
            + (f"render {row['render_mrays_s']:.1f} Mrays/s, "
               f"{row['render_launches']} launches; "
               if "render_mrays_s" in row else "")
            + f"auto at this spp: pack "
            f"{M.auto_pack(row['film'][0] * row['film'][1], row['spp'])} "
            f"[{card}]")
    with open(os.path.join(OUT_DIR, "pack_sweep.json"), "w") as f:
        json.dump(sweep, f)
    phase_done(25)

    # 26. the Mosaic probes P-r3n and P-r3w: their path is
    # rene_tpu_torch.probes' run; then each kernel's plain version timed,
    # the bounds, the chain floors, the reps guard and M4
    from rene_tpu_torch import probes as PRB
    from rene_tpu_torch.ops import probes as PR
    reset_launches()
    r3n = PRB.r3n(dev)
    r3w = PRB.r3w(dev)
    torch.cuda.synchronize()
    l_prb = dict(kernels.launches)
    prb_names = ["rowslice_probe"] + ["mxu_probe_" + k
                                      for k in kernels.MXU_KINDS]
    if not all(l_prb[k] > 0 for k in prb_names) \
            or sum(l_prb.values()) != sum(l_prb[k] for k in prb_names):
        raise RuntimeError(f"the probes' path launched {l_prb}")
    if not all(ok for ok, _ in r3n.values()) \
            or not all(r3w[k]["ok"] for k in kernels.MXU_KINDS):
        raise RuntimeError("a probe disagrees with its plain version")
    # a kernel whose reps were hoisted takes as long at 100 reps as at 200
    if not all(r3w[k]["ratio"] >= PRB.RATIO_MIN for k in kernels.MXU_KINDS):
        raise RuntimeError(
            f"a probe's 200 reps took less than {PRB.RATIO_MIN}x its 100 "
            f"(each less one rep's launch): "
            f"{[r3w[k]['ratio'] for k in kernels.MXU_KINDS]}")
    if not PRB.m4_agrees(r3w["m4"]):
        raise RuntimeError("M4 on the card is not the CPU's")
    fl = PRB.floors(dev, verbose=False)
    _, box, geom = PR.r3n_tables()
    box, geom = box.to(dev), geom.to(dev)
    r3n_plain_ms = PRB.launch_ms(lambda: PR.rowslice_ref(3, 3, box, geom))
    r3n_bound = bound(4 + 2 * 8 * 128 * 4, 0)
    b_, r_ = (x.to(dev) for x in PR.r3w_inputs())
    prb_rows = {"rowslice_probe": {
        "err": 0.0, "ms": max(ms for _, ms in r3n.values()),
        "plain_ms": r3n_plain_ms, "bound": r3n_bound, "library_ms": None,
        "floor_ms": fl["floor_ms"]["rowslice_probe"]}}
    b16, r16 = b_.bfloat16(), r_.bfloat16()
    io_bytes = (b_.numel() + r_.numel() + b_.shape[0] * r_.shape[1]) * 4
    for kind, rate, lib in (
            ("hi", TF32_OPS, lambda: torch.matmul(b_, r_)),
            ("def", BF16_OPS, lambda: torch.matmul(b16, r16)),
            ("vpu", FP32_OPS, None)):
        v = r3w[kind]
        plain_ms = PRB.launch_ms(lambda: PR.mxu_ref(kind, b_, r_))
        ops = PR.mxu_flops(kind, b_, r_) * PR.R3W_REPS
        bnd = bound(io_bytes if kind != "vpu" else (16 + 2 * 1024) * 4, ops,
                    rate)
        want = PR.mxu_ref(kind, b_, r_)
        err = float((v["out"] - want).abs().max())
        # the library's time for a launch's work: R3W_REPS products
        prb_rows["mxu_probe_" + kind] = {
            "err": err, "ms": v["ms"], "plain_ms": plain_ms, "bound": bnd,
            "library_ms": PRB.launch_ms(lib, PR.R3W_REPS) if lib else None,
            "floor_ms": fl["floor_ms"][kind]}
        log(f"mxu_probe {kind} ({PRB.R3W_NAMES[kind]}, {PR.R3W_REPS} reps "
            f"per launch): "
            f"{v['us_per_rep']:.4f} us per rep, {v['ms']:.5f} ms per launch "
            f"(parent {PRB.PARENT_MS[kind]:.5f}); chain floor "
            f"{fl['floor_ms'][kind]:.5f} ms; bound {bnd[0]:.5f} ms "
            f"({bnd[1]}; {ops / 1e6:.2f} MFLOP); {PR.R3W_REPS} reps / "
            f"{PRB.HALF_REPS}, less one rep's launch: {v['ratio']:.3f}; "
            f"plain {plain_ms:.3f} ms; "
            + (f"{PR.R3W_REPS} torch.matmul calls "
               f"{prb_rows['mxu_probe_' + kind]['library_ms']:.4f} ms; "
               if lib else "")
            + f"max abs {err:.3g} [{card}]")
    log(f"rowslice_probe: bit for bit, {prb_rows['rowslice_probe']['ms']:.5f}"
        f" ms per launch (parent {PRB.PARENT_MS['rowslice_probe']:.5f}), "
        f"floor (an empty launch) {fl['empty_ms']:.5f} ms, plain "
        f"{r3n_plain_ms:.4f} ms, bound {r3n_bound[0]:.7f} ms ({r3n_bound[1]})"
        f" [{card}]")
    log(f"M4 sign-test agreement: card {r3w['m4'] * 100:.2f}%, the CPU "
        f"{PRB.m4(torch.device('cpu')) * 100:.2f}% of {PRB.M4_PAIRS} pairs; "
        f"SM clock {fl['ghz']:.4f} GHz [{card}]")
    phase_done(26)

    # 27. resumable renders, the denoisers and --warm-cache
    resume_and_denoise(dev, card, {"big_mesh": big_path,
                                   "deep_mesh": deep_path})
    phase_done(27)

    # 28. the XLA engine
    xla_engine(dev, card)
    phase_done(28)

    # 29. renders over ranks of torch.distributed
    multi_device(dev, card, {"big_mesh": big_path, "deep_mesh": deep_path})
    phase_done(29)

    # 30. the denoiser's trainer
    training(dev, card)
    phase_done(30)

    if any(m.split(".")[0] in ("jax", "rene_tpu") for m in sys.modules):
        raise RuntimeError("jax or rene_tpu was imported")
    log(f"smoke: {time.time() - t_smoke:.1f} s")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd,
              library_ms, shape):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms, "shape": shape}

    pp_ = "rene_tpu/integrators/pallas_path.py"
    pw_ = "rene_tpu/integrators/pallas_wave.py"

    sob_launch = {**l_s_corn, **{k: v for k, v in l_s_big.items() if v},
                  **{k: v for k, v in l_s_fs.items() if v},
                  **{k: v for k, v in l_s_fog.items() if v}}
    sob_wave_launch = {"wave_path" + S_: l_s_cw,
                       "wave_path_mesh" + S_: l_s_bigw,
                       "wave_volpath" + S_: l_s_fsw,
                       "wave_volpath_mesh" + S_: l_s_fogw}
    sob_src = {"mega": "rene_tpu_torch/csrc/mega_lane.cuh",
               "wave": "rene_tpu_torch/csrc/wave.cuh"}
    sob_rep = {"mega_path": f"{pp_}:1708 :1718 (ld2, sob_pixkey) in kernel "
                            f":4328-4341, body :4437-4542",
               "mega_volpath": f"{pp_}:1708 :1718 in kernel :4328-4341, "
                               f"body_vol :4704-4812",
               "wave_path": f"{pw_}:271 ({pp_}:5643-5660 wave_kernel, "
                            f":5125-5228 wave_bounce)",
               "wave_volpath": f"{pw_}:271 ({pp_}:5643-5660 wave_kernel, "
                               f":5407-5512 wave_bounce_vol)"}
    sobol_entries = []
    for inst, m in mega_s.items():
        base = inst[:-len(S_)]
        sobol_entries.append(entry(
            inst, sob_src["mega"], sob_rep[base.replace("_mesh", "")],
            sob_launch[inst], m["err"], m["ms"], m["plain_ms"], m["bound"],
            None, f"{m['shape']}; independent instance {m['ind_ms']:.3f} ms "
            f"in turns; plain and max_abs_err on {m['plain_at']}"))
    # the volpath instances' fifth launches (phase 18) count in their
    # max_abs_err
    fifth_err = {
        "wave_volpath" + S_: k2_fifth["fog", "sobol"]["err"],
        "wave_volpath_mesh" + S_: k2_fifth["fog mesh", "sobol"]["err"]}
    for inst, k in k2_s.items():
        base = inst[:-len(S_)]
        sobol_entries.append(entry(
            inst, sob_src["wave"], sob_rep[base.replace("_mesh", "")],
            sob_wave_launch[inst][inst],
            max(k["err"], fifth_err.get(inst, 0.0)), k["ms"], k["plain_ms"],
            k["bound"], None,
            f"{k['what']}, first launch (k 1); independent "
            f"instance {k['ind_ms']:.3f} ms in turns; plain on "
            f"{k['sampled']} sampled lanes of it"))
    k3 = k3_s["sobol"]
    sobol_entries.append(entry(
        "wave_genesis" + S_, sob_src["wave"], f"{pw_}:630 ({pp_}:4999-5009)",
        l_s_cw["wave_genesis" + S_], k3["err"], k3["ms"], k3["plain_ms"],
        k3["bound"], None,
        f"cornell 1024x1024 x spw {LANES24_SPW} ({k3['n_pad']} lanes); "
        f"independent instance {k3_s['independent']['ms']:.3f} ms; "
        f"max_abs_err on lanes {LANES24[0]}..{LANES24[1]}"))
    sobol_entries.append(entry(
        "sobol_probe", "rene_tpu_torch/csrc/wave.cuh",
        "scripts/tpu_session_r3ac.py:53 (k_xorshift :70, k_addmul :81, "
        "k_rev :91, k_lk :106, k_sobol16 :117)", l_probe["sobol_probe"], 0.0,
        probe_ms, probe_plain_ms, probe_bound, None,
        f"{PROBE_N} int32 inputs, 7 words out each"))
    k1f_rep = f"{pp_}:4307-4337 (slot layout, Sobol key), :5897-5938, " \
              f":5976-5980, :6053"
    k1f_entries = []
    for inst, rows in k1f.items():
        t = max(rows, key=lambda x: x["pack"])
        k1f_entries.append(entry(
            inst + ":pack", "rene_tpu_torch/csrc/mega_lane.cuh", k1f_rep,
            l_pack[inst], max(x["err"] for x in rows), t["ms"],
            t["plain_ms"], t["bound"], None,
            f"{'fog' if 'vol' in inst else 'big'} mesh {MESH_W}x{MESH_H} at "
            f"pack {t['pack']}, one sample per lane ({t['pack']} spp); plain "
            f"on {t['sampled']} sampled lanes of it at maxdepth "
            f"{t['depth']}, in the plain walk of its launches at packs "
            f"{t['packs']}"))
    prb_rep = {"rowslice_probe": "scripts/tpu_session_r3n.py:72 (k_p1 :46, "
                                 "k_p2 :52, k_p3 :58)",
               "mxu_probe_hi": "scripts/tpu_session_r3w.py:46 (k_mxu_hi :67)",
               "mxu_probe_def": "scripts/tpu_session_r3w.py:46 "
                                "(k_mxu_def :77)",
               "mxu_probe_vpu": "scripts/tpu_session_r3w.py:46 (k_vpu :86)"}
    prb_entries = [dict(entry(
        k, "rene_tpu_torch/csrc/probes.cu", prb_rep[k], l_prb[k], v["err"],
        v["ms"], v["plain_ms"], v["bound"], v["library_ms"],
        "(32,128), (8,2048) -> (8,128) f32, mode 3, group 3"
        if k == "rowslice_probe" else
        f"(384,8) @ (8,1024) f32, {PR.R3W_REPS} reps per launch"),
        chain_floor_ms=v["floor_ms"]) for k, v in prb_rows.items()]
    log(json.dumps({"kernels": [
        entry("mega_path", "rene_tpu_torch/csrc/mega_path.cu",
              f"{pp_}:4266", l_k1a["mega_path"],
              max([a_mat["max_abs"], a_main["max_abs"]]
                  + [m for acc, m, _ in a_tex.values() if not acc]), k1a_ms,
              k1a_plain_ms, k1a_bound, None, "cornell 1024x1024 x 1 spp"),
        entry("mega_path_mesh", "rene_tpu_torch/csrc/mega_path.cu",
              f"{pp_}:2255 :2440 :2636 :2663", l_mesh["mega_path_mesh"],
              max(a["max_abs"] for a in a_mesh + [a_big]), mesh_ms,
              mesh_plain_ms, mesh_bound, None,
              f"big mesh {MESH_W}x{MESH_H} x 1 spp; plain on {pix.numel()} "
              f"sampled lanes of it at maxdepth {BIG_MESH_CHECK_DEPTH}, in "
              f"one walk with those of packs {list(PATH_PACKS)}"),
        entry("wave_path", "rene_tpu_torch/csrc/wave.cu",
              f"{pw_}:271 ({pp_}:5567)", l_cw["wave_path"],
              max([a_wave["materials"]["max_abs"], k2_mat["err"]]
                  + [c["err"] for c in k2_corn]
                  + [w for acc, _, w in a_tex.values() if not acc]),
              k2_corn[0]["ms"],
              k2_corn[0]["plain_ms"], k2_corn[0]["bound"], None,
              f"cornell 1024x1024 x spw 16, first launch (k 1); plain on "
              f"{k2_corn[0]['sampled']} sampled lanes of it"),
        entry("wave_path_mesh", "rene_tpu_torch/csrc/wave.cu",
              f"{pw_}:271 ({pp_}:5567)", l_wave["wave_path_mesh"],
              max([a_wave["mesh_materials"]["max_abs"],
                   a_wave["instanced"]["max_abs"], k2_small["err"]]
                  + [c["err"] for c in k2_deep]), k2_deep[0]["ms"],
              k2_deep[0]["plain_ms"], k2_deep[0]["bound"], None,
              f"deep mesh {MESH_W}x{MESH_H} x spw {spw}, first launch (k 1); "
              f"plain on {k2_deep[0]['sampled']} sampled lanes of it"),
        entry("mega_path_mesh:textured",
              "rene_tpu_torch/csrc/texture.cuh",
              f"{pp_}:1797 :4171 :2713 :1938 :1967-2050 :4451-4506",
              l_tex["mega_path_mesh"],
              max([a_texm["max_abs"]] + [m for acc, m, _ in a_tex.values()
                                         if acc]),
              texm_ms, a_texm["plain_s"] * 1e3, texm_bound, None,
              f"textured mesh {MESH_W}x{MESH_H} x 1 spp; plain on "
              f"{pix.numel()} sampled lanes of it"),
        entry("wave_path_mesh:textured",
              "rene_tpu_torch/csrc/texture.cuh",
              f"{pp_}:5140-5181 (wave_bounce) with :1797 :4171",
              l_texw["wave_path_mesh"],
              max([k2_tex["err"], k2_tex5["err"]]
                  + [w for acc, _, w in a_tex.values() if acc]),
              k2_tex["ms"],
              k2_tex["plain_ms"], k2_tex["bound"], None,
              f"textured deep mesh {MESH_W}x{MESH_H} x spw {spw}, first "
              f"launch (k 1); plain on {k2_tex['sampled']} sampled lanes"),
        entry("mega_volpath", "rene_tpu_torch/csrc/mega_lane.cuh",
              f"{pp_}:4572 (body_vol, with :3287-3430)", l_fs["mega_volpath"],
              max([v_fs["err"], smoke["max_abs"]]
                  + [m for acc, m, _ in a_vol.values() if not acc]),
              v_fs["ms"], v_fs["plain_ms"], v_fs["bound"], None,
              f"fog {MESH_W}x{MESH_H} x 1 spp; plain on {pix.numel()} "
              f"sampled lanes of it at maxdepth {VOL_CHECK_DEPTH}; its "
              f"queued instance on the Cornell smoke scene at "
              f"{SMOKE_SIZE}x{SMOKE_SIZE} x {SMOKE_SPP} spp {smoke_ms:.3f} "
              f"ms, bound {smoke_bound[0]:.4f} ms ({smoke_bound[1]}), plain "
              f"on {smoke['sampled']} sampled lanes at {SMOKE_CHECK_SPP} "
              f"spp"),
        entry("mega_volpath_mesh", "rene_tpu_torch/csrc/mega_lane.cuh",
              f"{pp_}:4572 (body_vol, with :3287-3430)",
              l_fog["mega_volpath_mesh"],
              max([v_fog["err"]] + [m for acc, m, _ in a_vol.values()
                                    if acc]), v_fog["ms"],
              v_fog["plain_ms"], v_fog["bound"], None,
              f"fog mesh {MESH_W}x{MESH_H} x 1 spp, maxdepth 64; plain on "
              f"{pix.numel()} sampled lanes of it at maxdepth "
              f"{VOL_CHECK_DEPTH}, in one walk with those of packs "
              f"{list(VOL_PACKS)}"),
        entry("wave_volpath", "rene_tpu_torch/csrc/wave.cuh",
              f"{pw_}:271 ({pp_}:5277 wave_bounce_vol)", l_fsw["wave_volpath"],
              max([k2_fs["err"], k2_fifth["fog", "independent"]["err"]]
                  + [w for acc, _, w in a_vol.values() if not acc]),
              k2_fs["ms"],
              k2_fs["plain_ms"], k2_fs["bound"], None,
              f"fog {MESH_W}x{MESH_H} x spw 16, first launch (k 1); plain "
              f"on {k2_fs['sampled']} sampled lanes of it"),
        entry("wave_volpath_mesh", "rene_tpu_torch/csrc/wave.cuh",
              f"{pw_}:271 ({pp_}:5277 wave_bounce_vol)",
              l_fogw["wave_volpath_mesh"],
              max([k2_fog["err"], k2_fifth["fog mesh", "independent"]["err"]]
                  + [w for acc, _, w in a_vol.values() if acc]),
              k2_fog["ms"],
              k2_fog["plain_ms"], k2_fog["bound"], None,
              f"fog mesh {MESH_W}x{MESH_H} x spw 16, first launch (k 1); "
              f"plain on {k2_fog['sampled']} sampled lanes of it"),
        entry("wave_genesis", "rene_tpu_torch/csrc/wave.cu",
              f"{pw_}:630 ({pp_}:4970)", l_wave["wave_genesis"], k3_err,
              k3_ms, k3_plain_ms, k3_bound, None,
              f"deep mesh {MESH_W}x{MESH_H} x spw {spw}"),
        entry("wave_permute", "rene_tpu_torch/csrc/wave.cu", f"{pw_}:386",
              l_dma["wave_permute"], 0.0, k4_ms, k4_plain_ms, k4_bound,
              k4_lib_ms, f"deep mesh {MESH_W}x{MESH_H} x spw {spw} state"),
    ] + sobol_entries + k1f_entries + prb_entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
