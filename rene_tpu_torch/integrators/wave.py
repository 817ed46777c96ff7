"""The wavefront engine on the port (slices K2, K3, K4).

Counterpart of rene_tpu/integrators/pallas_wave.py `make_pallas_wave_fn`
(:71) with the wave kernels of rene_tpu/integrators/pallas_path.py.
Where the megakernel keeps each lane's path in registers from its first
camera ray to its last sample, this engine keeps every in-flight path of
a wave in one (W_NROWS, n_pad) float32 state array in device memory and
advances it a few bounces per launch, regrouping the lanes between
launches so that neighbouring lanes trace neighbouring rays:

    genesis (K3, `wave_genesis`)         a fresh wave: want split, camera
                                         jitter and ray, regen sort key
    per step, schedule (1, 1, 1, 2, 4):
      sort (from the second step on)     `gather`: octant x Morton bin key,
                                         a stable sort, a gather of rows
                                         [0, 21); `dma`: slice keys, an
                                         argsort, K4 (`wave_permute`)
      K2 (`wave_[vol]path[_mesh]`)       k bounces of every alive lane of
                                         the first nt tiles, in place
    finish                               group by pixel, sum each pixel's
                                         spw lanes

Each lane's random stream is seeded from its lane id, the wave seed and
the launch index (`rng.wave_state`), so a sort only moves lanes: every
lane traces the same path in any order. With the JAX kernel's
interpret-mode seeding (stream "jax") a film agrees with the JAX wave
engine's interpret mode per pixel; that seeding ties the draws of one
path's launches to each other and biases the image, so the default
stream ("mixed"), the only one the CUDA kernels draw, hashes the seed
first. The plain versions here
(`genesis_ref`, `wave_step_ref`, `permute_ref`) run on the CPU and are
what chip_smoke.py holds the CUDA kernels (csrc/wave.cu) to.

What is not carried over, all tuned for the TPU: the XLA init (its
jitter comes from jax.random's threefry, so the port always starts a
wave with K3), `dir_bits = 6`, `oct_major = False`, `dir_sub`,
`key_mode = "kernel"`, `sort_gran` other than 1 and 128, `sub_tris`,
`sub_gate`, `check_every`, the RENE_WAVE* switches and the multichip
`mesh`. The next-launch key of a mesh hit carries `1<<23 | morton18(hit)`
where the JAX kernel carries its 128-triangle cluster id: the port has
no clusters. That changes the order of the lanes in `dma` sorts, never a
lane's result.

Under `Sampler "sobol"` a lane draws the Sobol pairs of the megakernel
(mega_path.py) keyed by its pixel and the wave seed, at the pixel-global
sample index scum + smp: scum = q * base + min(q, rem) counts the
samples of the pixel's lanes of lower slot q = lane // npix, where the
wave's `want` samples per pixel split into base * spw + rem
(pallas_path.py:4999-5009, :5125-5228, :5407-5512, :5643-5660). A Sobol
path lane draws nothing from its stream; a volpath lane draws its
medium, phase and scatter-point emitter draws there. Sorts move lanes,
never a lane's draws.

Volpath waves (slice K1e) run the volpath bounce (integrators/volpath.py)
in K2 (`wave_volpath[_mesh]`) and carry each lane's medium in row
WROW_MED = 21, which K3 starts at vacuum and every sort moves with the
rows before it, as JAX's volpath waves do.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import numpy as np
import torch

from .. import kernels
from ..ops import rng
from ..scene import pack as P
from ..utils.checkpoint import SUMS
from .camera import camera_ray
from ..ops import sobol as SB
from .mega_path import bounce, device_tables, ray_increment, sobol_draws
from .volpath import bounce_vol

# -- the state rows (pallas_path.py:148-181) ---------------------------------
WROW_O, WROW_D, WROW_C, WROW_R = 0, 3, 6, 9   # origin, dir, throughput,
                                              # radiance sums
WROW_ALIVE, WROW_RAYS = 12, 13
WROW_LANE = 14      # the lane id: int32 bits in a float32 row, exact at
                    # any wave size (`lane_ids`)
WROW_PX, WROW_PY, WROW_SMP, WROW_DEP = 15, 16, 17, 18
WROW_WANT = 19      # the lane's sample target
WROW_KEY = 20       # next-launch sort key: int32 bits in a float32 row
W_SORT_ROWS = 21    # rows a `gather` sort moves in a path wave
WROW_MED = 21       # volpath waves: the lane's medium, which a `gather`
                    # sort moves too (W_SORT_ROWS + 1 rows, as JAX's)
W_SORT_PAD = 24     # rows K4 moves; rows 21-23 are zero in path waves
WROW_AN, WROW_AA = 24, 27   # AOV normal / albedo sums
W_NROWS = 32
DEAD_ORIGIN = 1e30  # origin of a parked lane

W_SLICE = 128       # lanes a K4 permutation moves as one unit
W_TILE = 1024       # pallas_path.MESH_TILE_SUB * 128: the JAX grid step,
                    # kept so that lane ids and pad lanes match JAX's
SCHEDULE = (1, 1, 1, 2, 4)  # bounces per launch (pallas_wave.py:234)
W_KEY_DEAD = 0x3F000000     # | W_KEY_BIT: a parked lane sorts last
W_KEY_BIT = 0x40000000      # in every key: a positive normal float


def auto_spw(npix: int, spp_hint: int = 0) -> int:
    """Lanes per pixel of a wave, `auto_spw` (pallas_wave.py:54) with its
    TPU cap of 96: a budget of 3<<23 lanes (~2.8 GB of state and sort
    buffers), clamped to the render's spp. Kept so that the lane layout
    at a given spp equals the reference's; the TPU numbers behind the
    cap are not the card's (PERF.md, open questions)."""
    cap = 96
    hint = max(2, spp_hint) if spp_hint > 0 else cap
    return max(2, min(cap, (3 << 23) // npix, hint))


def scene_bounds(buffers_np, config) -> Tuple[Tuple[float, ...], ...]:
    """(lo, ext) of the origin Morton cells (pallas_wave.py:184-202): the
    immediates' and spheres' box with a 5% margin each side."""
    ntri = config.num_triangles
    pts = buffers_np["tri_p"][:ntri].reshape(-1, 3).astype(np.float64)
    if pts.size == 0:
        lo, hi = np.zeros(3), np.ones(3)
    else:
        lo, hi = pts.min(axis=0), pts.max(axis=0)
    for s in range(config.num_spheres):
        m = buffers_np["sph_o2w"][s].astype(np.float64)
        r = sum(math.sqrt(m[0][c] ** 2 + m[1][c] ** 2 + m[2][c] ** 2)
                for c in range(3)) / 3.0    # pallas_path._sphere_radius
        c = m[:3, 3]
        lo = np.minimum(lo, c - r)
        hi = np.maximum(hi, c + r)
    ext = np.maximum(hi - lo, 1e-9)
    lo = lo - 0.05 * ext
    ext = ext * 1.1
    return tuple(float(v) for v in lo), tuple(float(v) for v in ext)


def key_bounds(lo, ext) -> Tuple[float, ...]:
    """The six float32 constants of the in-kernel hit key: lo xyz and
    64 / ext xyz, as the JAX kernel bakes them (`_q6` :4914)."""
    return tuple(float(np.float32(v)) for v in
                 (*lo, *(64.0 / e for e in ext)))


def pixel_sums(sums) -> Dict:
    """A wave's (9, npix) sums (`finish_wave`'s rows: radiance, normal,
    albedo) as the film's per-pixel (npix, 3) sums, by SUMS' names."""
    return {k: sums[3 * i:3 * i + 3].T for i, k in enumerate(SUMS)}


def lane_layout(width: int, height: int, spw: int) -> Dict:
    """The fixed lane layout of a wave (pallas_wave.py:499-522): 32x32
    pixel blocks, samples outermost, one sample slot per lane (slot =
    lane // npix), real lanes padded to whole 1024-lane tiles."""
    npix = width * height
    n_real = npix * spw
    n_pad = -(-n_real // W_TILE) * W_TILE
    bs = 32
    ys, xs = np.mgrid[0:height, 0:width]
    blk = (ys // bs) * (-(-width // bs)) + (xs // bs)
    order = np.argsort((blk * bs * bs + (ys % bs) * bs
                        + (xs % bs)).reshape(-1),
                       kind="stable").astype(np.int64)
    pix = np.concatenate([np.tile(order, spw),
                          npix + np.arange(n_pad - n_real, dtype=np.int64)])
    clip = np.minimum(pix, npix - 1)
    return {"npix": npix, "spw": spw, "n_real": n_real, "n_pad": n_pad,
            "order": order, "pix": pix,
            "pxf": (clip % width).astype(np.float32),
            "pyf": (clip // width).astype(np.float32)}


# -- sort keys ---------------------------------------------------------------
def _f32(x: float) -> float:
    return float(np.float32(x))


def oct_of(a, b, g) -> torch.Tensor:
    """Direction octant: 4 (x < 0) + 2 (y < 0) + (z < 0)."""
    return ((a < 0.0).long() * 4 + (b < 0.0).long() * 2
            + (g < 0.0).long())


def _mpart6(v):
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton18(hx, hy, hz, kb) -> torch.Tensor:
    """18-bit Morton cell of a hit point (`_morton18` :4918); `kb` is
    `key_bounds`."""
    q = [torch.clamp((v - kb[a]) * kb[3 + a], 0.0, 63.0).long()
         for a, v in enumerate((hx, hy, hz))]
    return _mpart6(q[0]) | (_mpart6(q[1]) << 1) | (_mpart6(q[2]) << 2)


def regen_key(pxf, pyf, dx, dy, dz, width: int) -> torch.Tensor:
    """Key of a lane on a fresh camera ray (`_regen_key` :4934): octant x
    its 32x32 pixel block."""
    bi = (torch.floor(pyf * (1.0 / 32.0)) * float(-(-width // 32))
          + torch.floor(pxf * (1.0 / 32.0))).long()
    return (oct_of(dx, dy, dz) << 24) | (1 << 22) \
        | torch.clamp_max(bi, 0x3FFFFF)


def pack_key(alive, regen, k_al, k_re) -> torch.Tensor:
    """The key row's float32 bit pattern (`_pack_key` :4943)."""
    key = torch.where(alive, k_al, torch.where(regen, k_re, W_KEY_DEAD))
    return (key | W_KEY_BIT).to(torch.int32).view(torch.float32)


def bin_key(state: torch.Tensor, lo, ext) -> torch.Tensor:
    """The `gather` sort key (pallas_wave.py:291-337 with dir_bits 3,
    octant major): direction octant x 8-bit-per-axis Morton cell of the
    origin; parked lanes 0x7FFFFFFF."""
    def part10(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    q = [torch.clamp((state[WROW_O + a] - _f32(lo[a])) / _f32(ext[a])
                     * 256.0, 0.0, 255.0).to(torch.int32) for a in range(3)]
    morton = part10(q[0]) | (part10(q[1]) << 1) | (part10(q[2]) << 2)
    d = state[WROW_D:WROW_D + 3]
    key = (oct_of(d[0], d[1], d[2]).to(torch.int32) << 24) | morton
    return torch.where(state[WROW_ALIVE] > 0.5, key, 0x7FFFFFFF)


# -- K3: genesis -------------------------------------------------------------
def lane_ids(state: torch.Tensor) -> torch.Tensor:
    """The int64 lane ids of a wave state's columns (row WROW_LANE)."""
    return state[WROW_LANE].view(torch.int32).long()


def sample_base(lane: torch.Tensor, npix: int, base: int,
                rem: int) -> torch.Tensor:
    """scum: the samples of a lane's pixel that its lanes of lower slot
    q = lane // npix take, in a wave of base * spw + rem samples per
    pixel (the first `rem` slots take base + 1)."""
    q = lane // npix
    return q * base + torch.clamp_max(q, rem)


def lane_start(lane: torch.Tensor, npix: int, n_real: int, base: int,
               rem: int):
    """K3's integer lane math: each lane's sample slot q = lane // npix
    and its share `want` of a wave of base * spw + rem samples per pixel
    (0 for the pad lanes), exact at any wave size (the JAX kernel
    computes them in float32, exact below 2^23 lanes)."""
    q = lane // npix
    return q, torch.where(lane < n_real, base + (q < rem).long(), 0)


def genesis_ref(cam, pxf, pyf, width: int, npix: int, n_real: int,
                seed: int, base: int, rem: int, stream: str = "mixed",
                sobol: bool = False, lanes=None) -> torch.Tensor:
    """Plain PyTorch genesis kernel (`genesis_kernel`
    pallas_path.py:4970-5048): the (W_NROWS, n_pad) state of a fresh wave
    whose lanes share want = base * spw + rem samples per pixel. `cam`
    is the camera row as python floats, `pxf`/`pyf` the lanes' pixel
    coordinates, `stream` the lane streams (rng.wave_state). `sobol`:
    the camera jitter is the Sobol pair of the lane's first sample
    (`sample_base`) under the wave seed's pixel key. `lanes`: the int64
    ids of the lanes whose columns to compute, by default all, lane j in
    column j (pxf and pyf then hold those lanes' coordinates)."""
    n_pad = pxf.shape[0]
    lane = (torch.arange(n_pad, device=pxf.device) if lanes is None
            else lanes.to(torch.int64))
    _, want = lane_start(lane, npix, n_real, base, rem)
    alive = want > 0
    st = rng.wave_state(lane, seed, -1, stream)
    if sobol:
        pixkey = SB.pixkey(pxf.long() + pyf.long() * width, int(seed))
        ju, jv = SB.ld2(sample_base(lane, npix, base, rem), pixkey, 0,
                        SB.SLOT_CAM)
    else:
        ju, st = rng.uniform(st)
        jv, st = rng.uniform(st)
    dx, dy, dz = camera_ray(cam, pxf, pyf, ju, jv)
    key = pack_key(alive, alive & False, regen_key(pxf, pyf, dx, dy, dz,
                                                   width), 0)
    state = torch.zeros((W_NROWS, n_pad), dtype=torch.float32,
                        device=pxf.device)
    for a in range(3):
        state[WROW_O + a] = torch.where(
            alive, cam[P.CAM_ORIGIN + a], DEAD_ORIGIN)
    state[WROW_D], state[WROW_D + 1], state[WROW_D + 2] = dx, dy, dz
    state[WROW_C:WROW_C + 3] = 1.0
    state[WROW_ALIVE] = alive.float()
    state[WROW_LANE] = lane.to(torch.int32).view(torch.float32)
    state[WROW_PX], state[WROW_PY] = pxf, pyf
    state[WROW_WANT] = want.float()
    state[WROW_KEY] = key
    return state


# -- K2: k bounces -----------------------------------------------------------
_STATE_KEYS = (("ox", WROW_O), ("oy", WROW_O + 1), ("oz", WROW_O + 2),
               ("dx", WROW_D), ("dy", WROW_D + 1), ("dz", WROW_D + 2),
               ("cr", WROW_C), ("cg", WROW_C + 1), ("cb", WROW_C + 2),
               ("rr", WROW_R), ("rg", WROW_R + 1), ("rb", WROW_R + 2),
               ("alive", WROW_ALIVE), ("rays", WROW_RAYS),
               ("px", WROW_PX), ("py", WROW_PY), ("smp", WROW_SMP),
               ("depth", WROW_DEP), ("want", WROW_WANT), ("key", WROW_KEY),
               ("anx", WROW_AN), ("any", WROW_AN + 1), ("anz", WROW_AN + 2),
               ("aar", WROW_AA), ("aag", WROW_AA + 1), ("aab", WROW_AA + 2))


def wave_bounce(tabs, c, kb, beckmann: bool = False) -> Dict:
    """One bounce of every lane of `c` (`wave_bounce`
    pallas_path.py:5052-5275, or `wave_bounce_vol` :5277-5565 for
    volpath tables): the megakernel's path body (`bounce`, or
    volpath.bounce_vol), then regeneration while smp < want, parking at
    DEAD_ORIGIN and the next-launch key, `1<<23 | morton18` of the next
    origin (the surface hit, or the scatter point in a medium) under the
    new direction's octant. Dead lanes keep their state; their key is
    the parked key they already hold. A regenerated lane starts in
    vacuum. Under Sobol `c` holds each lane's `scum` and `pixkey`; its
    draws take the sample index scum + smp, the camera's that after the
    finished path is counted."""
    cam = tabs["cam_f"]
    co = cam[P.CAM_ORIGIN:P.CAM_ORIGIN + 3]
    was_alive = c["alive"] > 0.5
    rays = c["rays"] + torch.where(was_alive, 1.0, 0.0) * ray_increment(tabs)
    if tabs["sobol"]:
        c = dict(c, sob=sobol_draws(c["scum"] + c["smp"].long(),
                                    c["pixkey"], c["depth"].long()))
    b = (bounce_vol if tabs["volpath"] else bounce)(tabs, c, was_alive,
                                                    beckmann)
    alive = b["alive"]
    finished = was_alive & ~alive
    smp = c["smp"] + torch.where(finished, 1.0, 0.0)
    regen = finished & (smp < c["want"])
    if tabs["sobol"]:
        cj1, cj2 = SB.ld2(c["scum"] + smp.long(), c["pixkey"], 0,
                          SB.SLOT_CAM)
    else:
        cj1, cj2 = b["cj1"], b["cj2"]
    cdx, cdy, cdz = camera_ray(cam, c["px"], c["py"], cj1, cj2)
    park = finished & ~regen
    k_al = (oct_of(b["wx"], b["wy"], b["wz"]) << 24) | (1 << 23) \
        | morton18(b["hx"], b["hy"], b["hz"], kb)
    key = pack_key(alive, regen, k_al,
                   regen_key(c["px"], c["py"], cdx, cdy, cdz,
                             tabs["width"]))

    def pick3(a1, a2, b2c):
        return torch.where(regen, a1, torch.where(alive, a2, b2c))

    out = dict(c)
    for k, hk, o in (("ox", "hx", co[0]), ("oy", "hy", co[1]),
                     ("oz", "hz", co[2])):
        out[k] = pick3(o, b[hk], torch.where(park, DEAD_ORIGIN, c[k]))
    for k, wk, cd in (("dx", "wx", cdx), ("dy", "wy", cdy),
                      ("dz", "wz", cdz)):
        out[k] = pick3(cd, b[wk], c[k])
    for k in ("cr", "cg", "cb"):
        out[k] = pick3(1.0, b[k], c[k])
    for k in ("rr", "rg", "rb", "anx", "any", "anz", "aar", "aag", "aab"):
        out[k] = b[k]
    out["alive"] = torch.where(alive | regen, 1.0, 0.0)
    out["rays"] = rays
    out["smp"] = smp
    out["depth"] = torch.where(regen, 0.0, torch.where(
        alive, c["depth"] + 1.0, c["depth"]))
    out["key"] = key
    out["st"] = b["st"]
    out.pop("sob", None)
    if tabs["volpath"]:
        out["med"] = pick3(0.0, b["med"], c["med"])
    return out


def wave_step_ref(tabs, state: torch.Tensor, seed: int, launch: int, k: int,
                  n_run: int, kb, base: int, rem: int,
                  beckmann: bool = False,
                  stream: str = "mixed") -> torch.Tensor:
    """Plain PyTorch wave kernel (`wave_kernel` pallas_path.py:5567-5706):
    advance every alive lane of the first `n_run` lanes of `state` by `k`
    bounces, in place, with the lane streams `stream` of launch `launch`
    (rng.wave_state); `kb` is `key_bounds`. Under Sobol the wave's
    base * spw + rem samples per pixel place each lane's sample indices
    (`sample_base`). Returns `state`."""
    idx = torch.nonzero(state[WROW_ALIVE, :n_run] > 0.5).squeeze(1)
    if not idx.numel():
        return state
    rows = state.index_select(1, idx)
    keys = _STATE_KEYS + ((("med", WROW_MED),) if tabs["volpath"] else ())
    c = {name: rows[r] for name, r in keys}
    lane = lane_ids(rows)
    c["st"] = rng.wave_state(lane, seed, launch, stream)
    if tabs["sobol"]:
        npix = tabs["width"] * tabs["height"]
        c["scum"] = sample_base(lane, npix, base, rem)
        c["pixkey"] = SB.pixkey(c["px"].long() + c["py"].long()
                                * tabs["width"], int(seed))
    for _ in range(k):
        c = wave_bounce(tabs, c, kb, beckmann)
    for name, r in keys:
        rows[r] = c[name]
    state.index_copy_(1, idx, rows)
    return state


# -- K4: slice permutation ---------------------------------------------------
def permute_ref(state: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch slice permutation (`_dma_perm_kernel`
    pallas_wave.py:370-383): out[:24, slice j] = state[:24, slice
    perm[j]] over 128-lane slices; rows 24-31 (the AOVs) pass through."""
    n_pad = state.shape[1]
    out = torch.empty_like(state)
    out[:W_SORT_PAD] = state[:W_SORT_PAD].view(
        W_SORT_PAD, n_pad // W_SLICE, W_SLICE).index_select(
            1, perm.long()).view(W_SORT_PAD, n_pad)
    out[W_SORT_PAD:] = state[W_SORT_PAD:]
    return out


def unsort_lanes(rows: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """`rows` with column j moved back to column lane[j], the lane it
    started as (`lane_ids`): the inverse of the `gather` sorts'
    permutation."""
    return torch.empty_like(rows).index_copy_(1, lane, rows)


# -- the runner --------------------------------------------------------------
def make_wave_fn(buffers_np, config, device, samples_per_wave: int = 0,
                 sort_mode: str = "gather", sort_rays: bool = True,
                 spp_hint: int = 0, k_schedule=None, stream: str = "mixed"):
    """Runner of the wave engine, `make_pallas_wave_fn`'s counterpart:
    `run(seed, num_samples)` renders one wave of min(num_samples, spw)
    samples per pixel and returns per-pixel (N, 3) radiance/normal/albedo
    SUMS and the ray count; `run.run_dev(seed, n, accum)` keeps them on
    the device, added to `accum`, and `run.read_back` turns them into
    the dict. Raises NotImplementedError for scenes the port does not
    carry (`pack.slice_supported`). `stream`: the lane streams
    (rng.wave_state); "jax" reproduces the JAX interpret-mode waves, for
    the tests that compare with them, on the CPU only.

    On a CUDA device every launch runs a CUDA kernel (K3 once per wave,
    K2 once per step in the scene's variant, K4 per `dma` sort and once
    before the finish), counted in `kernels.launches`; on the CPU the
    plain versions run. There is no fallback between the two."""
    if sort_mode not in ("gather", "dma"):
        raise ValueError(f"sort_mode {sort_mode!r}: 'gather' or 'dma'")
    if stream not in rng.WAVE_STREAMS:
        raise ValueError(f"stream {stream!r}: one of {rng.WAVE_STREAMS}")
    device = torch.device(device)
    tables = P.pack_tables(buffers_np, config)
    tabs = device_tables(tables, device)
    beckmann = os.environ.get("RENE_MF_DIST", "") == "beckmann"
    W, H = tables.width, tables.height
    spw = samples_per_wave or auto_spw(W * H, spp_hint)
    lay = lane_layout(W, H, spw)
    npix, n_real, n_pad = lay["npix"], lay["n_real"], lay["n_pad"]
    ns_all = n_pad // W_SLICE
    lo, ext = scene_bounds(buffers_np, config)
    kb = key_bounds(lo, ext)
    schedule = tuple(k_schedule) if k_schedule else SCHEDULE
    maxd = tables.max_depth
    n_sort = W_SORT_ROWS + (1 if tables.volpath else 0)
    pxf = torch.from_numpy(lay["pxf"]).to(device)
    pyf = torch.from_numpy(lay["pyf"]).to(device)
    inv_order = torch.from_numpy(np.argsort(lay["order"])).to(device)
    cuda = device.type == "cuda"
    pinned = torch.empty((), dtype=torch.int64, pin_memory=cuda)

    def init_state(seed: int, want: int):
        """A fresh wave of `want` samples per pixel; lane j starts in
        column j (row WROW_LANE), and the sorts move the row with it."""
        return kernels.wave_genesis(tabs, pxf, pyf, n_real, int(seed),
                                    want // spw, want % spw, stream)

    def kernel_step(k: int, state, seed: int, launch: int, nt: int,
                    want: int):
        """One K2 launch over the first nt tiles of a wave of `want`
        samples per pixel; returns the state and the count of lanes that
        bounds the alive prefix (whole slices for `dma`)."""
        kernels.wave_path(tabs, state, int(seed), int(launch), k,
                          nt * W_TILE, kb, want // spw, want % spw,
                          beckmann, stream)
        alive = state[WROW_ALIVE] > 0.5
        if sort_mode == "dma":
            n_alive = alive.view(ns_all, W_SLICE).any(1).sum() * W_SLICE
        else:
            n_alive = alive.sum()
        return state, n_alive

    def sort_prefix(state, m: int):
        """Regroup the lanes: `gather` sorts the first m lanes by
        `bin_key` (stable) and moves rows [0, 21), and the medium row of
        a volpath wave; `dma` sorts all slices by their least key and
        moves them with K4."""
        if sort_mode == "dma":
            skey = state[WROW_KEY].view(ns_all, W_SLICE).min(1).values
            perm = torch.argsort(skey, stable=True).to(torch.int32)
            return kernels.wave_permute(state, perm)
        sub = state[:n_sort, :m]
        perm = torch.argsort(bin_key(sub, lo, ext), stable=True)
        state[:n_sort, :m] = sub.index_select(1, perm)
        return state

    def bucket(n_lanes: int) -> int:
        """Smallest power-of-4 tile count covering n_lanes lanes."""
        m = W_TILE * 4
        while m < min(n_lanes, n_pad):
            m *= 4
        return min(m, n_pad)

    def finish_wave(state):
        """(9, npix) per-pixel sums of radiance, normal and albedo over
        the wave's lanes, and the ray total (float64). The radiance rows
        go back to the initial lane order first, by the lane ids
        (`lane_ids`; `dma`: K4 with the inverse of the slice order that
        each slice's first id gives; `gather`: a scatter), so every pixel
        sums its lanes in one order wherever the sorts put them. The AOV
        rows, written in step 0 and moved by no sort, are in it
        already."""
        rays = state[WROW_RAYS].sum(dtype=torch.float64)
        lane = lane_ids(state)
        if sort_mode == "dma":
            inv = torch.argsort(lane[::W_SLICE], stable=True).to(torch.int32)
            rad = kernels.wave_permute(state, inv)[WROW_R:WROW_R + 3]
        else:
            rad = unsort_lanes(state[WROW_R:WROW_R + 3], lane)
        sums = torch.cat([
            rad[:, :n_real].reshape(3, spw, npix).sum(1),
            state[WROW_AN:WROW_AN + 6, :n_real].reshape(6, spw, npix)
            .sum(1)])
        return sums.index_select(1, inv_order), rays

    def run_dev(seed: int, num_samples: int, accum=None, split=None):
        """One wave of min(num_samples, spw) samples; returns the device
        pair (sums, rays), added to `accum` when given. `split` (CUDA
        only): a dict to which the device time in ms of the wave's init,
        K2 launches, sorts and finish is added (CUDA events)."""
        marks = []

        def mark(label):
            if split is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((label, ev))

        mark("start")
        want = min(int(num_samples), spw)
        state = init_state(seed, want)
        mark("init")
        prefix = last_alive = n_real
        per_lane = -(-want // spw)
        max_launches = -(-maxd * per_lane // min(schedule)) + 8
        pending = None
        for si in range(max_launches):
            k = schedule[min(si, len(schedule) - 1)]
            if sort_rays and si >= 1:
                m = n_pad if sort_mode == "dma" else bucket(prefix)
                state = sort_prefix(state, m)
                nt = min(-(-last_alive // W_TILE), m // W_TILE)
                prefix = nt * W_TILE
                mark("sort")
            else:
                nt = -(-prefix // W_TILE)
            state, n_alive = kernel_step(k, state, seed, si, nt, want)
            mark("K2")
            # the early exit reads the previous step's count while this
            # step runs: counts never rise, so a one-step-stale count
            # still bounds the alive prefix
            if pending is not None:
                if cuda:
                    pending.synchronize()
                last_alive = int(pinned)
                if last_alive == 0:
                    break
            pinned.copy_(n_alive, non_blocking=cuda)
            if cuda:
                pending = torch.cuda.Event()
                pending.record()
            else:
                pending = True
        sums, rays = finish_wave(state)
        mark("finish")
        del state
        if accum is not None:
            sums, rays = accum[0] + sums, accum[1] + rays
        if marks:
            marks[-1][1].synchronize()
            for (_, e0), (label, e1) in zip(marks, marks[1:]):
                split[label] = split.get(label, 0.0) + e0.elapsed_time(e1)
        return sums, rays

    def read_back(acc) -> Dict:
        out = {k: np.ascontiguousarray(v.numpy())
               for k, v in pixel_sums(acc[0].cpu()).items()}
        out["rays"] = float(acc[1])
        return out

    def run(seed: int, num_samples: int) -> Dict:
        return read_back(run_dev(seed, num_samples))

    run.run_dev = run_dev
    run.read_back = read_back
    run.chunk_hint = spw
    run.samples_per_wave = spw
    run.spp_mult = 1
    run.n_pad = n_pad
    run.n_real = n_real
    run.init_state = init_state
    run.kernel_step = kernel_step
    run.sort_prefix = sort_prefix
    run.finish_wave = finish_wave
    run.bucket = bucket
    run.tabs = tabs
    run.key_bounds = kb
    run.layout = lay
    run.pxf, run.pyf = pxf, pyf
    return run
