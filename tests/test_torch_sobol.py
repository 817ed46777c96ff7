"""The port's Sobol sampler (K-sobol) and the exact wave lane ids.

* rene_tpu_torch/ops/sobol.py against rene_tpu/ops/sobol.py bit for bit,
  function by function, on all 2^16 sample indices under several keys;
  its `ld2` and `pixkey` against the JAX megakernel's formulas
  (pallas_path.py:1697-1720, transcribed here with jnp over the
  reference's `ld2_bits`);
* csrc/sobol.cuh compiled with g++ (the ladder in place of `__brev`)
  against the plain version bit for bit;
* the properties tests/test_sobol.py holds the reference to (the base
  sequence and its scramble are (0,2)-nets, distinct keys decorrelate
  the pads, integration beats iid), on the port's version;
* the wave lane ids past 2^24: the plain K3's lane math (the slot q,
  `want`, the lane id row, the initial streams) at lanes 2^24 .. 2^24 +
  4096 of a 1024x1024 wave at spw 24, where float32 ids are 2 apart, and
  csrc/wave.cuh's `lane_start` with g++ on the same lanes.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rene_tpu.ops import sobol as R
from rene_tpu_torch import kernels, scenes
from rene_tpu_torch.integrators import mega_path as M
from rene_tpu_torch.integrators import wave as WV
from rene_tpu_torch.pbrt import parse_pbrt
from rene_tpu_torch.scene import build_device_scene, create_scene
from rene_tpu_torch.scene import pack as P
from rene_tpu_torch.ops import rng
from rene_tpu_torch.ops import sobol as SB
from .test_torch_kernel_source import _gxx

torch.set_num_threads(2)

KEYS = (0, 7, 123456789, 0x9E3779B9, 0xFFFFFFFF)
IDX = np.arange(1 << 16, dtype=np.uint32)


def _u32(t):
    return np.asarray(t).astype(np.int64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _unit(bits):
    return _u32(bits) * (1.0 / 2 ** 32)


@pytest.mark.parametrize("name", ["reverse32", "hash_u32", "laine_karras",
                                  "owen_scramble", "sobol2_16", "ld2_bits"])
def test_ops_match_reference_bit_for_bit(name):
    """Every function of ops/sobol.py on all 2^16 indices: alone, and
    under each key (the hashes and scrambles also on the keyed words)."""
    ref = {"reverse32": R.reverse32, "hash_u32": R.hash_u32,
           "laine_karras": R._laine_karras, "owen_scramble": R.owen_scramble,
           "sobol2_16": R.sobol2_16, "ld2_bits": R.ld2_bits}[name]
    port = getattr(SB, name)
    for key in KEYS:
        x = IDX if name in ("sobol2_16", "ld2_bits") \
            else IDX * np.uint32(0x01000193) ^ np.uint32(key)
        if name in ("laine_karras", "owen_scramble", "ld2_bits"):
            want, got = ref(jnp.asarray(x), jnp.uint32(key)), \
                port(_t(x), key)
        else:
            want, got = ref(jnp.asarray(x)), port(_t(x))
        if name == "ld2_bits":
            for w, g in zip(want, got):
                np.testing.assert_array_equal(_u32(g), np.asarray(w))
        else:
            np.testing.assert_array_equal(_u32(got), np.asarray(want))
    assert SB.SOBOL2_DIRS == R.SOBOL2_DIRS


def _jax_ld2(idx, keyv, depth, slot):
    """pallas_path.py:1708-1716 in interpret mode."""
    key = (keyv ^ (jnp.asarray(depth, jnp.uint32) * jnp.uint32(0x9E3779B9))
           ^ jnp.uint32((slot * 0x632BE59B) & 0xFFFFFFFF))
    ub, vb = R.ld2_bits(jnp.asarray(idx, jnp.uint32) & jnp.uint32(0xFFFF),
                        key)

    def unit(b):
        m = (b >> jnp.uint32(9)) | jnp.uint32(0x3F800000)
        return np.asarray(jnp.asarray(m).view(jnp.float32) - 1.0)
    return unit(ub), unit(vb)


def test_ld2_and_pixkey_match_the_kernel_formulas():
    """`ld2` (draw pairs of every slot at several depths, indices past
    2^16 masked) and `pixkey` (pid = px + py * W, the seed's product)
    against the JAX megakernel's float pixel id and uint32 algebra."""
    g = np.random.default_rng(3)
    n = 1 << 14
    idx = g.integers(0, 1 << 20, n).astype(np.uint32)
    keyv = g.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    for depth in (0, 1, 13, 63):
        for slot in range(7):
            got = SB.ld2(_t(idx), _t(keyv), depth, slot)
            want = _jax_ld2(idx, jnp.asarray(keyv), depth, slot)
            for w, gt in zip(want, got):
                np.testing.assert_array_equal(gt.numpy(), w)
                assert (w >= 0).all() and (w < 1).all()
    W, H = 1280, 720
    px = g.integers(0, W, n).astype(np.float32)
    py = g.integers(0, H, n).astype(np.float32)
    for seed in (0, 1234567, 2 ** 31 - 1 + 65537 * 5):
        seed_u = jnp.uint32(seed & 0xFFFFFFFF)
        pid = (jnp.asarray(px) + jnp.asarray(py) * float(W)).astype(
            jnp.int32).view(jnp.uint32)
        want = R.hash_u32(pid ^ (seed_u * jnp.uint32(0x85EBCA6B)))
        got = SB.pixkey(torch.from_numpy(px).long()
                        + torch.from_numpy(py).long() * W, seed)
        np.testing.assert_array_equal(_u32(got), np.asarray(want))


HARNESS = r"""
#include <cstring>
#include <cstdint>
#include <cstddef>
#define __device__
#define __forceinline__ inline
static inline float __uint_as_float(uint32_t u) {
  float f; memcpy(&f, &u, 4); return f;
}
#include "sobol.cuh"
// per input word x and key k: reverse32(x), hash_u32(x), laine_karras(x,
// k), owen_scramble(x, k), sobol2_16(x & 0xFFFF), ld2_bits(x & 0xFFFF, k)
// (two words), sob_pixkey(x, k), and the bits of the float pair
// ld2(x, k, depth, slot)
extern "C" void sobol_rows(const uint32_t* x, const uint32_t* k, int n,
                           uint32_t depth, uint32_t slot, uint32_t* out) {
  for (int i = 0; i < n; ++i) {
    uint32_t u, v;
    ld2_bits(x[i] & 0xFFFFu, k[i], u, v);
    float fu, fv;
    ld2(x[i], k[i], depth, slot, fu, fv);
    uint32_t bu, bv;
    memcpy(&bu, &fu, 4);
    memcpy(&bv, &fv, 4);
    const uint32_t row[10] = {reverse32(x[i]), hash_u32(x[i]),
                              laine_karras(x[i], k[i]),
                              owen_scramble(x[i], k[i]),
                              sobol2_16(x[i] & 0xFFFFu), u, v,
                              sob_pixkey(x[i], k[i]), bu, bv};
    for (int r = 0; r < 10; ++r) out[(size_t)r * n + i] = row[r];
  }
}
"""


@pytest.fixture(scope="module")
def sobol_lib(tmp_path_factory):
    lib = _gxx(tmp_path_factory, "host_sobol", HARNESS)
    p = ctypes.c_void_p
    lib.sobol_rows.argtypes = [p, p, ctypes.c_int, ctypes.c_uint32,
                               ctypes.c_uint32, p]
    return lib


@pytest.mark.parametrize("depth,slot", [(0, 0), (5, 3), (40, 6)])
def test_cuda_sobol_header_matches_plain_version(sobol_lib, depth, slot):
    """csrc/sobol.cuh with g++ against ops/sobol.py, bit for bit, on 2^16
    random words and keys."""
    g = np.random.default_rng(depth)
    n = 1 << 16
    x = g.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    k = g.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    out = np.empty((10, n), np.uint32)
    sobol_lib.sobol_rows(x.ctypes.data, k.ctypes.data, n, depth, slot,
                         out.ctypes.data)
    tx, tk = _t(x), _t(k)
    u, v = SB.ld2_bits(tx & 0xFFFF, tk)
    fu, fv = SB.ld2(tx, tk, depth, slot)
    want = [SB.reverse32(tx), SB.hash_u32(tx), SB.laine_karras(tx, tk),
            SB.owen_scramble(tx, tk), SB.sobol2_16(tx & 0xFFFF), u, v,
            SB.pixkey(tx, tk), fu.view(torch.int32), fv.view(torch.int32)]
    for r, w in enumerate(want):
        np.testing.assert_array_equal(out[r], _u32(w), err_msg=str(r))


# -- the properties of tests/test_sobol.py, on the port's version -------------
def _net_counts(u, v, k):
    for j1 in range(k + 1):
        j2 = k - j1
        cells = (np.floor(u * (1 << j1)).astype(int) * (1 << j2)
                 + np.floor(v * (1 << j2)).astype(int))
        yield (j1, j2), np.bincount(cells, minlength=1 << k)


@pytest.mark.parametrize("key", [None, 7, 123456789])
def test_points_are_02_nets(key):
    """The first 2^8 points, unscrambled (`key` None) and under an Owen
    scramble: one point in every elementary interval of area 2^-8."""
    k = 8
    idx = torch.arange(1 << k)
    if key is None:
        u, v = _unit(SB.reverse32(idx)), _unit(SB.sobol2_16(idx))
    else:
        u, v = (_unit(w) for w in SB.ld2_bits(idx, key))
    for shape, counts in _net_counts(u, v, k):
        assert counts.max() == 1 and counts.min() == 1, (key, shape)


def test_scramble_uniform_and_pads_decorrelated():
    """Distinct keys re-pair the pads: dimension 2 across keys
    decorrelates and the joint (u1, u2) fills a 16x16 grid; a key
    reproduces itself."""
    idx = torch.arange(4096)
    u1, v1 = SB.ld2_bits(idx, 11)
    u2, v2 = SB.ld2_bits(idx, 12)
    a, b = _unit(v1), _unit(v2)
    assert abs(a.mean() - 0.5) < 0.02 and abs(b.mean() - 0.5) < 0.02
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.06
    cell = (np.floor(_unit(u1) * 16).astype(int) * 16
            + np.floor(_unit(u2) * 16).astype(int))
    assert (np.bincount(cell, minlength=256) > 0).mean() > 0.95
    assert torch.equal(SB.ld2_bits(idx, 11)[0], u1)


def test_sobol_beats_independent_on_integration():
    """RMSE of a smooth 2D integral with 256 samples: the scrambled
    points beat iid uniform by 3x or more."""
    def f(x, y):
        return np.sin(3 * x) * (y ** 2) + x
    ref = (-(np.cos(3) - 1) / 3) * (1 / 3) + 0.5
    idx = torch.arange(256)
    g = np.random.default_rng(0)
    errs_s, errs_i = [], []
    for t in range(64):
        u, v = SB.ld2_bits(idx, 1000 + t)
        errs_s.append(f(_unit(u), _unit(v)).mean() - ref)
        x = g.random((2, 256))
        errs_i.append(f(x[0], x[1]).mean() - ref)
    rmse_s = np.sqrt(np.mean(np.square(errs_s)))
    rmse_i = np.sqrt(np.mean(np.square(errs_i)))
    assert rmse_s * 3.0 < rmse_i, (rmse_s, rmse_i)


# -- wave lane ids past 2^24 --------------------------------------------------
W24, H24, SPW24 = 1024, 1024, 24     # auto_spw's wave at 5000 spp
LANES24 = torch.arange(1 << 24, (1 << 24) + 4096)


def test_wave_is_past_2_24_lanes():
    """`--engine wave` at the default 5000 spp on a 1024x1024 film runs
    24 lanes per pixel, 25.2 M lanes."""
    assert WV.auto_spw(W24 * H24, 5000) == SPW24
    assert W24 * H24 * SPW24 > (1 << 24) + 4096
    # float32 ids there are 2 apart: neighbouring lanes would share one
    assert torch.unique(LANES24.float()).numel() == 2049


@pytest.mark.parametrize("base,rem,sobol", [(1, 0, False), (0, 20, True),
                                            (1, 0, True)])
def test_plain_genesis_ids_exact_past_2_24(base, rem, sobol):
    """genesis_ref on lanes 2^24 .. 2^24 + 4096 of the 1024x1024 x spw 24
    wave: the lane row holds each lane's id exactly, `want` is
    base + (q < rem) with q = lane // npix, the initial "mixed" streams
    are pairwise distinct, and under Sobol the camera draws follow the
    exact sample index (the next 4096 lanes, another slot of the same
    pixels, draw other jitter)."""
    npix = W24 * H24
    n_real = npix * SPW24
    lay_pix = LANES24 % npix
    pxf, pyf = (lay_pix % W24).float(), (lay_pix // W24).float()
    cam = M.device_tables(P.pack_tables(*build_device_scene(create_scene(
        parse_pbrt(scenes.cornell_box(W24, H24)), "/tmp"))), "cpu")["cam_f"]
    state = WV.genesis_ref(cam, pxf, pyf, W24, npix, n_real, 5, base, rem,
                           sobol=sobol, lanes=LANES24)
    ids = WV.lane_ids(state)
    assert torch.equal(ids, LANES24)
    q = LANES24 // npix
    assert int(q[0]) == 16
    want = base + (q < rem).long()
    assert torch.equal(state[WV.WROW_WANT], want.float())
    st = rng.wave_state(ids, 5, -1)
    assert torch.unique(st).numel() == LANES24.numel()
    if sobol:
        other = WV.genesis_ref(cam, pxf, pyf, W24, npix, n_real, 5, base,
                               rem, sobol=True, lanes=LANES24 + npix)
        d = state[WV.WROW_D:WV.WROW_D + 3] - other[WV.WROW_D:WV.WROW_D + 3]
        assert (d.abs().amax(0) > 0).all()


LANE_HARNESS = r"""
#include <cmath>
#include <cstring>
#include <cstdint>
#include <cstddef>
#define __device__
#define __forceinline__ inline
#define __ldg(p) (*(p))
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
static inline float __uint_as_float(uint32_t u) {
  float f; memcpy(&f, &u, 4); return f;
}
static inline uint32_t __float_as_uint(float f) {
  uint32_t u; memcpy(&u, &f, 4); return u;
}
#pragma GCC diagnostic ignored "-Wunused-function"
#include "wave.cuh"
// K3's lane math for lanes[i]: rows q, want, the initial stream, and the
// first Sobol sample index
extern "C" void k3_lanes(const uint32_t* lanes, int n, int npix, int n_real,
                         int base, int rem, int seed, uint32_t* out) {
  GenesisParams g = {};
  g.npix = npix;
  g.n_real = n_real;
  g.base = base;
  g.rem = rem;
  g.seed = (uint32_t)seed;
  for (int i = 0; i < n; ++i) {
    const LaneStart ls = lane_start(g, lanes[i]);
    out[i] = ls.q;
    out[n + i] = (uint32_t)ls.want;
    out[2 * n + i] = ls.st;
    out[3 * n + i] = sample_base(ls.q, base, rem);
  }
}
"""


def test_cuda_k3_lane_math_exact_past_2_24(tmp_path_factory):
    """csrc/wave.cuh's `lane_start` and `sample_base` with g++ on lanes
    2^24 .. 2^24 + 4096 and on the last lanes of the wave: equal to the
    plain version's q, want, streams and sample indices."""
    lib = _gxx(tmp_path_factory, "host_k3_lanes", LANE_HARNESS)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k3_lanes.argtypes = [p, i, i, i, i, i, i, p]
    npix = W24 * H24
    n_real = npix * SPW24
    lanes = torch.cat([LANES24, torch.arange(n_real - 2048, n_real + 2048)])
    for base, rem in ((1, 0), (0, 20)):
        arr = lanes.numpy().astype(np.uint32)
        out = np.empty((4, arr.size), np.uint32)
        lib.k3_lanes(arr.ctypes.data, arr.size, npix, n_real, base, rem, 5,
                     out.ctypes.data)
        q, want = WV.lane_start(lanes, npix, n_real, base, rem)
        np.testing.assert_array_equal(out[0], q.numpy())
        np.testing.assert_array_equal(out[1], want.numpy())
        np.testing.assert_array_equal(out[2],
                                      _u32(rng.wave_state(lanes, 5, -1)))
        np.testing.assert_array_equal(
            out[3], WV.sample_base(lanes, npix, base, rem).numpy())
        assert (out[1][lanes.numpy() >= n_real] == 0).all()


def test_probe_plain_version_matches_the_mosaic_probe_formulas():
    """ops/sobol.py `probe_ref` (through the wrapper, on the CPU) against
    the checks of scripts/tpu_session_r3ac.py's five probes (its numpy
    xor-shift and add-multiply, the reference's reverse32, Laine-Karras
    and sobol2_16) and the reference's ld2_bits, on the probe's (8, 128)
    input."""
    x = np.random.default_rng(0).integers(0, 2 ** 31, (8, 128),
                                          dtype=np.int32).reshape(-1)
    out = _u32(kernels.sobol_probe(torch.from_numpy(x)))
    xu = x.astype(np.uint32)
    w = xu ^ ((xu << 13) & 0xFFFFFFFF)
    np.testing.assert_array_equal(out[0], w ^ (w >> 7))
    w2 = ((xu.astype(np.uint64) + 0x9E3779B9) & 0xFFFFFFFF) \
        * np.uint64(0x85EBCA6B) & np.uint64(0xFFFFFFFF)
    np.testing.assert_array_equal(out[1], w2.astype(np.uint32))
    np.testing.assert_array_equal(out[2],
                                  np.asarray(R.reverse32(jnp.asarray(xu))))
    np.testing.assert_array_equal(out[3], np.asarray(R._laine_karras(
        jnp.asarray(xu), jnp.uint32(0x51633E2D))))
    np.testing.assert_array_equal(
        out[4], np.asarray(R.sobol2_16(jnp.asarray(xu & 0xFFFF))))
    u, v = R.ld2_bits(jnp.asarray(xu & 0xFFFF), jnp.asarray(xu))
    np.testing.assert_array_equal(out[5], np.asarray(u))
    np.testing.assert_array_equal(out[6], np.asarray(v))
