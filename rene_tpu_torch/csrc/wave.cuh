// Per-lane code of the wavefront engine: the genesis of a wave (K3), k
// bounces of one lane of a wave (K2), path or volpath, and one warp's
// copy of a 128-lane slice of the slice permutation (K4). Mirrors
// rene_tpu_torch/integrators/wave.py (`genesis_ref`, `wave_bounce`,
// `wave_step_ref`, `permute_ref`), which mirror pallas_path.py:4970-5048
// (genesis_kernel), :5052-5275 (wave_bounce), :5277-5565
// (wave_bounce_vol) and :5567-5706 (wave_kernel), and
// pallas_wave.py:370-383 (_dma_perm_kernel); and the Sobol probe
// (`probe_lane`, scripts/tpu_session_r3ac.py). Included by wave.cu; plain
// C++ apart from the CUDA qualifiers and intrinsics, so
// tests/test_torch_kernel_source.py compiles it with g++ too.
//
// A lane's id lies in row WROW_LANE as its int32 bits, so that it is
// exact at any wave size; a lane's slot q = lane / npix, its `want` and
// (under Sobol) its first sample index scum = q * base + min(q, rem) are
// integers. SOBOL: the instance of `Sampler "sobol"`, whose draws are
// Sobol pairs (csrc/sobol.cuh) at the pixel-global sample index
// scum + smp, keyed by the pixel and the wave seed
// (pallas_path.py:4999-5009, :5125-5228, :5407-5512, :5643-5660).
#pragma once
#include <stdint.h>

#include "layout.cuh"
#include "path.cuh"
#include "path_loop.cuh"
#include "vol_loop.cuh"

struct WaveParams {
  Scene s;
  int width, npix, max_depth, use_rr, beckmann, has_accel;
  int sobol;       // launch the SOBOL instance
  int base, rem;   // want = base * spw + rem samples per pixel (Sobol)
  uint32_t seed;
  int launch;      // step index of the wave: seeds the lane streams
  int k;           // bounces of this launch
  int n_run;       // lanes [0, n_run) are advanced
  int n_pad;       // lanes of the state (its row stride)
  float klo[3];    // key cells: lo xyz and 64 / ext xyz (float32)
  float kscale[3];
  float* __restrict__ state;
  const float* __restrict__ media;  // (n_media, MED_W), read by volpath
  int n_media;
};

struct GenesisParams {
  const float* __restrict__ cam;
  const float* __restrict__ px;
  const float* __restrict__ py;
  int width, npix, n_real, n_pad;
  uint32_t seed;
  int base, rem;   // want = base * spw + rem samples per pixel
  int sobol;       // launch the SOBOL instance
  float* __restrict__ state;
};

// the first pixel-global sample index of slot q's lane of a pixel: the
// samples of its lanes of lower slot, the first `rem` of which take
// base + 1
__device__ __forceinline__ uint32_t sample_base(uint32_t q, int base,
                                                int rem) {
  return q * (uint32_t)base + (q < (uint32_t)rem ? q : (uint32_t)rem);
}

// the Sobol key of the pixel at (px, py) of a wave with seed `seed`
__device__ __forceinline__ uint32_t wave_pixkey(float px, float py, int width,
                                                uint32_t seed) {
  return sob_pixkey((uint32_t)px + (uint32_t)py * (uint32_t)width, seed);
}

// MurmurHash3's 32-bit finalizer (rng.fmix32)
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// lane stream of launch `launch` (-1: genesis), tied to the lane id: the
// "mixed" stream of rng.wave_state, the JAX interpret-mode seed hashed so
// that a lane's launches draw unrelated streams. The JAX form itself
// (stream "jax") exists only in the plain version, for the tests that
// compare with the JAX engine.
__device__ __forceinline__ uint32_t wave_state(uint32_t lane, uint32_t seed,
                                               int launch) {
  uint32_t seed_u = seed + (uint32_t)(launch + 1) * 7919u;
  return fmix32((lane * 2654435761u) ^ fmix32(seed_u)) | 1u;
}

__device__ __forceinline__ uint32_t oct_of(V3 d) {
  return (d.x < 0.f ? 4u : 0u) + (d.y < 0.f ? 2u : 0u) + (d.z < 0.f ? 1u : 0u);
}

// spread the 6 low bits to every third bit (`_mpart` :4906)
__device__ __forceinline__ uint32_t mpart6(uint32_t v) {
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  return (v | (v << 2)) & 0x09249249u;
}

__device__ __forceinline__ uint32_t q6(float v, float lo, float scale) {
  float x = mul_rn(sub_rn(v, lo), scale);
  return (uint32_t)fminf(fmaxf(x, 0.f), 63.f);
}

// key of a lane on a fresh camera ray: octant x 32x32 pixel block
__device__ __forceinline__ uint32_t regen_key(float px, float py, V3 d,
                                              int width) {
  float bw = (float)((width + 31) / 32);
  uint32_t bi = (uint32_t)(floorf(py * (1.f / 32.f)) * bw
                           + floorf(px * (1.f / 32.f)));
  return (oct_of(d) << 24) | (1u << 22) | (bi < 0x3FFFFFu ? bi : 0x3FFFFFu);
}

__device__ __forceinline__ float key_bits(uint32_t key) {
  return __uint_as_float(key | (uint32_t)W_KEY_BIT);
}

// K3's integer lane math: a lane's sample slot q = lane / npix, its
// share `want` of the wave's samples and its initial stream
struct LaneStart {
  uint32_t q;
  int want;
  uint32_t st;
};

__device__ __forceinline__ LaneStart lane_start(const GenesisParams& g,
                                                uint32_t lane) {
  LaneStart r;
  r.q = lane / (uint32_t)g.npix;
  r.want = lane < (uint32_t)g.n_real
      ? g.base + (r.q < (uint32_t)g.rem ? 1 : 0) : 0;
  r.st = wave_state(lane, g.seed, -1);
  return r;
}

// K3: the fresh-wave state of one lane, all W_NROWS rows
template <bool SOBOL>
__device__ __forceinline__ void genesis_lane(const GenesisParams& g,
                                             int lane) {
  const size_t N = (size_t)g.n_pad;
  LaneStart ls = lane_start(g, (uint32_t)lane);
  const bool alive = ls.want > 0;
  float px = g.px[lane], py = g.py[lane];
  float ju, jv;
  if constexpr (SOBOL) {
    ld2(sample_base(ls.q, g.base, g.rem),
        wave_pixkey(px, py, g.width, g.seed), 0u, SLOT_CAM, ju, jv);
  } else {
    ju = uniform(ls.st);
    jv = uniform(ls.st);
  }
  V3 d = camera_ray(g.cam, px, py, ju, jv);
  float* S = g.state + lane;
  for (int a = 0; a < 3; ++a) {
    S[(WROW_O + a) * N] = alive ? __ldg(g.cam + CAM_ORIGIN + a) : DEAD_ORIGIN;
    S[(WROW_C + a) * N] = 1.f;
    S[(WROW_R + a) * N] = 0.f;
  }
  S[WROW_D * N] = d.x;
  S[(WROW_D + 1) * N] = d.y;
  S[(WROW_D + 2) * N] = d.z;
  S[WROW_ALIVE * N] = alive ? 1.f : 0.f;
  S[WROW_RAYS * N] = 0.f;
  S[WROW_LANE * N] = __uint_as_float((uint32_t)lane);
  S[WROW_PX * N] = px;
  S[WROW_PY * N] = py;
  S[WROW_SMP * N] = 0.f;
  S[WROW_DEP * N] = 0.f;
  S[WROW_WANT * N] = (float)ls.want;
  S[WROW_KEY * N] = key_bits(alive ? regen_key(px, py, d, g.width)
                                   : (uint32_t)W_KEY_DEAD);
  // the rest, the medium row WROW_MED (vacuum) and the AOV sums among
  // them, start at zero
  for (int row = W_SORT_ROWS; row < W_NROWS; ++row) S[row * N] = 0.f;
}

// the rows K2 reads and writes for one lane; `med`, the medium row, in
// volpath waves only
struct WaveLane {
  V3 o, d;
  float c[3], r[3], an[3], aa[3];
  float alive, rays, px, py, smp, dep, want, key, med;
  uint32_t id;
};

// Lane `lane`'s rows, where it is alive (else false: a parked lane keeps
// its state and its parked key).
template <bool VOL>
__device__ __forceinline__ bool wave_load(const WaveParams& p, int lane,
                                          WaveLane& L) {
  const size_t N = (size_t)p.n_pad;
  const float* S = p.state + lane;
  if (!(S[WROW_ALIVE * N] > 0.5f)) return false;
  L.o = v3(S[WROW_O * N], S[(WROW_O + 1) * N], S[(WROW_O + 2) * N]);
  L.d = v3(S[WROW_D * N], S[(WROW_D + 1) * N], S[(WROW_D + 2) * N]);
  for (int c = 0; c < 3; ++c) {
    L.c[c] = S[(WROW_C + c) * N];
    L.r[c] = S[(WROW_R + c) * N];
    L.an[c] = S[(WROW_AN + c) * N];
    L.aa[c] = S[(WROW_AA + c) * N];
  }
  L.alive = 1.f;
  L.rays = S[WROW_RAYS * N];
  L.px = S[WROW_PX * N];
  L.py = S[WROW_PY * N];
  L.smp = S[WROW_SMP * N];
  L.dep = S[WROW_DEP * N];
  L.want = S[WROW_WANT * N];
  L.key = S[WROW_KEY * N];
  L.id = __float_as_uint(S[WROW_LANE * N]);
  L.med = 0.f;
  if constexpr (VOL) L.med = S[WROW_MED * N];
  return true;
}

// the rows of the path ray that a parked volpath lane keeps: medium,
// direction, throughput
__device__ __forceinline__ void wave_store_ray(const WaveParams& p, int lane,
                                               const WaveLane& L) {
  const size_t N = (size_t)p.n_pad;
  float* S = p.state + lane;
  S[WROW_MED * N] = L.med;
  S[WROW_D * N] = L.d.x;
  S[(WROW_D + 1) * N] = L.d.y;
  S[(WROW_D + 2) * N] = L.d.z;
  for (int c = 0; c < 3; ++c) S[(WROW_C + c) * N] = L.c[c];
}

// Lane `lane`'s rows; a parked volpath lane leaves those of
// wave_store_ray, which its last bounce wrote before its shading
template <bool VOL>
__device__ __forceinline__ void wave_store(const WaveParams& p, int lane,
                                           const WaveLane& L) {
  const size_t N = (size_t)p.n_pad;
  float* S = p.state + lane;
  const bool ray = !VOL || L.alive > 0.5f;
  if constexpr (VOL)
    if (ray) S[WROW_MED * N] = L.med;
  S[WROW_O * N] = L.o.x;
  S[(WROW_O + 1) * N] = L.o.y;
  S[(WROW_O + 2) * N] = L.o.z;
  if (ray) {
    S[WROW_D * N] = L.d.x;
    S[(WROW_D + 1) * N] = L.d.y;
    S[(WROW_D + 2) * N] = L.d.z;
  }
  for (int c = 0; c < 3; ++c) {
    if (ray) S[(WROW_C + c) * N] = L.c[c];
    S[(WROW_R + c) * N] = L.r[c];
    S[(WROW_AN + c) * N] = L.an[c];
    S[(WROW_AA + c) * N] = L.aa[c];
  }
  S[WROW_ALIVE * N] = L.alive;
  S[WROW_RAYS * N] = L.rays;
  S[WROW_SMP * N] = L.smp;
  S[WROW_DEP * N] = L.dep;
  S[WROW_KEY * N] = L.key;
}

// A lane's stream of this launch and, under SOBOL, the first sample index
// of its slot and its pixel's key
struct WaveDraw {
  uint32_t st, scum, pixkey;
};

template <bool SOBOL>
__device__ __forceinline__ WaveDraw wave_draw(const WaveParams& p,
                                              const WaveLane& L) {
  WaveDraw w = {wave_state(L.id, p.seed, p.launch), 0u, 0u};
  if constexpr (SOBOL) {
    w.scum = sample_base(L.id / (uint32_t)p.npix, p.base, p.rem);
    w.pixkey = wave_pixkey(L.px, L.py, p.width, p.seed);
  }
  return w;
}

// The end of a bounce of an alive lane, `alive` its verdict before the
// depth cut: the depth cut, then the next-launch key, 1<<23 | morton18
// of the next origin hp (the surface hit or the scatter point) under the
// new direction w_'s octant, with the next throughput nthr and medium
// next_med; else regeneration while smp < want (in vacuum, the camera
// pair cj1, cj2, under SOBOL drawn at the sample index after the
// finished path is counted) or parking at DEAD_ORIGIN, where the lane
// keeps its direction, throughput and medium.
template <bool SOBOL>
__device__ __forceinline__ void wave_tail(const WaveParams& p, WaveLane& L,
                                          bool alive, V3 hp, V3 w_,
                                          const float* nthr, float next_med,
                                          float cj1, float cj2,
                                          const WaveDraw& w) {
  const Scene& s = p.s;
  alive = alive && (L.dep + 1.f < (float)p.max_depth);
  if (alive) {
    uint32_t morton = mpart6(q6(hp.x, p.klo[0], p.kscale[0]))
        | (mpart6(q6(hp.y, p.klo[1], p.kscale[1])) << 1)
        | (mpart6(q6(hp.z, p.klo[2], p.kscale[2])) << 2);
    L.key = key_bits((oct_of(w_) << 24) | (1u << 23) | morton);
    L.o = hp;
    L.d = w_;
    for (int c = 0; c < 3; ++c) L.c[c] = nthr[c];
    L.med = next_med;
    L.dep = L.dep + 1.f;
    return;
  }
  L.smp = L.smp + 1.f;
  if (L.smp < L.want) {  // regenerate a camera path of the lane's pixel
    if constexpr (SOBOL)
      ld2(w.scum + (uint32_t)L.smp, w.pixkey, 0u, SLOT_CAM, cj1, cj2);
    L.d = camera_ray(s.cam, L.px, L.py, cj1, cj2);
    L.o = load3(s.cam + CAM_ORIGIN);
    L.c[0] = L.c[1] = L.c[2] = 1.f;
    L.dep = 0.f;
    L.med = 0.f;
    L.key = key_bits(regen_key(L.px, L.py, L.d, p.width));
  } else {  // park
    L.o = v3(DEAD_ORIGIN, DEAD_ORIGIN, DEAD_ORIGIN);
    L.alive = 0.f;
    L.key = key_bits((uint32_t)W_KEY_DEAD);
  }
}

// One bounce of an alive lane of a path wave in the immediates variant
// (`wave_bounce`): the megakernel's path body (mega_lane.cuh path_lane),
// its closest cast and then a shadow cast per distant light, then
// wave_tail. The draws are the megakernel's; under SOBOL at sample index
// scum + smp of the pixel keyed by `pixkey`.
template <bool SOBOL>
__device__ __forceinline__ void wave_bounce(const WaveParams& p, WaveLane& L,
                                            WaveDraw& w) {
  const Scene& s = p.s;
  const bool beck = p.beckmann != 0;
  const int E = s.n_eo;
  L.rays = L.rays + (1.f + (float)s.n_lights + (E > 0 ? 1.f : 0.f));
  V3 hp = L.o, w_ = L.d;
  float nthr[3] = {L.c[0], L.c[1], L.c[2]};
  const SobolAt at = {w.scum + (uint32_t)L.smp, w.pixkey, (uint32_t)L.dep};
  const Draws u = draw_bounce_as<SOBOL>(s, p.use_rr != 0, w.st, at);
  Hit h = trace_closest<false>(s, L.o, L.d, TMIN);
  bool alive = h.t < BIG;
  if (!alive) {
    float bg[3];
    background(s.cam, s.atlas, bg_kind(s), L.d, bg);
    for (int c = 0; c < 3; ++c) L.r[c] = L.r[c] + L.c[c] * bg[c];
  } else {
    Mat m = hit_material(s, h);
    hp = v3(L.o.x + h.t * L.d.x, L.o.y + h.t * L.d.y, L.o.z + h.t * L.d.z);
    V3 n = normalize3(h.n);
    V3 wo = neg(L.d);
    Frame f = onb_from_w(n);
    if ((h.e[0] != 0.f || h.e[1] != 0.f || h.e[2] != 0.f)
        && dot3(wo, n) > 0.f)
      for (int c = 0; c < 3; ++c) L.r[c] = L.r[c] + L.c[c] * h.e[c];
    if (L.dep == 0.f) {
      L.an[0] = L.an[0] + n.x;
      L.an[1] = L.an[1] + n.y;
      L.an[2] = L.an[2] + n.z;
      for (int c = 0; c < 3; ++c) L.aa[c] = L.aa[c] + m.ab[c];
    }
    V3 lo = to_local(f, wo);
    for (int li = 0; li < s.n_lights; ++li) {
      const float* Lt = s.lights + li * LIGHT_W;
      V3 ld = load3(Lt + LIGHT_DIR);
      if (shadow_any<false>(s, li, hp, ld, TMIN, 1e5f)) continue;
      BsdfVal fe = bsdf_eval(m, lo, to_local(f, ld), beck);
      float cosl = fabsf(ld.x * n.x + ld.y * n.y + ld.z * n.z);
      for (int c = 0; c < 3; ++c)
        L.r[c] = L.r[c]
            + L.c[c] * fe.f[c] * cosl * __ldg(Lt + LIGHT_COLOR + c);
    }
    alive = bsdf_step(s, m, f, n, lo, hp, u, beck, L.c, w_, nthr);
    // a throughput below the normal range counts as zero, as under the
    // flush-to-zero arithmetic of XLA and the TPU
    alive = alive
        && maxn(nthr[0], maxn(nthr[1], nthr[2])) >= FLT_MIN_NORMAL;
    if (p.use_rr) {
      float p_cont = clampn(maxn(nthr[0], maxn(nthr[1], nthr[2])), 0.f,
                            1.f);
      bool do_rr = L.dep > (float)RR_START;
      alive = alive && (!do_rr || u.rrv <= p_cont);
      if (do_rr && alive) {
        float inv_p = 1.f / clamp_min(p_cont, 1e-20f);
        for (int c = 0; c < 3; ++c) nthr[c] = nthr[c] * inv_p;
      }
    }
  }
  wave_tail<SOBOL>(p, L, alive, hp, w_, nthr, L.med, u.cj1, u.cj2, w);
}

// K2 of a path wave for one lane: its rows, k bounces, its rows. The mesh
// variant runs path_loop.cuh's state machine, one ray cast per step from
// one call site, the path ray or the next queued shadow ray, so that a
// warp's lanes walk together whichever ray each needs and the build holds
// one walk; after each bounce and its shadow rays, wave_tail. The
// immediates variant keeps the bounce above, its casts two brute-force
// loops (on its main path, the Cornell box without a distant light, the
// state machine measured 5-7% slower: PERF.md section 6). Both make the
// megakernel's path body's draws, casts and sums, in its order; a parked
// lane returns at once: its state, and its parked key, stay as they are.
template <bool MESH, bool SOBOL>
__device__ __forceinline__ void wave_lane(const WaveParams& p, int lane) {
  WaveLane L;
  if (!wave_load<false>(p, lane, L)) return;
  WaveDraw w = wave_draw<SOBOL>(p, L);
  if constexpr (!MESH) {
    for (int b = 0; b < p.k && L.alive > 0.5f; ++b)
      wave_bounce<SOBOL>(p, L, w);
  } else {
    const Scene& s = p.s;
    const bool beck = p.beckmann != 0;
    const float ray_inc =
        1.f + (float)s.n_lights + (s.n_eo > 0 ? 1.f : 0.f);
    PathLoop v;
    float sh[PATH_SH_W];
    path_loop_start(s, v);
    PathCounts cnt;
    for (int left = p.k; left > 0;) {
      const bool shadow = path_shadowing(s, v);
      if (!step_now(shadow)) continue;
      path_step<SOBOL>(
          s, beck, p.use_rr != 0, v, sh, shadow, L.o, L.d, L.c, L.rays,
          ray_inc, w.st,
          [&] {
            return SobolAt{w.scum + (uint32_t)L.smp, w.pixkey,
                           (uint32_t)L.dep};
          },
          L.r, L.an, L.aa, cnt, [&] {
            wave_tail<SOBOL>(p, L, v.alive, v.hp, v.w, v.nthr, L.med,
                             v.cj1, v.cj2, w);
            left = L.alive > 0.5f ? left - 1 : 0;
          });
    }
    if (L.alive < 0.5f) cnt.park();
    cnt.flush();
  }
  wave_store<false>(p, lane, L);
}

// K2 of a volpath wave for one lane (`wave_bounce_vol`): its rows, then
// vol_loop.cuh's state machine in its medium, one ray cast per step as in
// the megakernel's lane loop; when a bounce and all its marches are done,
// wave_tail; after k bounces, or where it parks, its rows. The draws,
// casts and sums are the bounce's (volpath.cuh vol_shade), in its order.
// A parked lane keeps the direction, throughput and medium its last
// bounce started with: where a bounce may end in parking (its path is the
// lane's last), their rows are written at its shade step, before the
// step replaces them, and the lane's store leaves them. A parked lane
// returns at once.
template <bool MESH, bool SOBOL>
__device__ __forceinline__ void wave_vol_lane(const WaveParams& p,
                                              int lane) {
  const Scene& s = p.s;
  const Media md = {p.media, p.n_media};
  const bool beck = p.beckmann != 0;
  const float ray_inc = 1.f + (float)s.n_lights + (s.n_eo > 0 ? 1.f : 0.f);
  WaveLane L;
  if (!wave_load<true>(p, lane, L)) return;
  WaveDraw w = wave_draw<SOBOL>(p, L);
  VolLoop v;
  vol_loop_start(v, L.o, L.d, L.med);
  StepCounts cnt;
  cnt.lane();
  for (int left = p.k; left > 0;) {
    const bool marching = vol_marching(v);
    if (!step_now(marching)) continue;
    cnt.step(marching);
    vol_step<MESH, SOBOL>(
        s, md, beck, v, marching, L.o, L.d, L.c, L.med, L.rays, ray_inc,
        w.st,
        [&] {
          if (L.smp + 1.f >= L.want) wave_store_ray(p, lane, L);
          return SobolAt{w.scum + (uint32_t)L.smp, w.pixkey,
                         (uint32_t)L.dep};
        },
        L.r, L.an, L.aa, [&] {
          // the path ray is the next one already
          wave_tail<SOBOL>(p, L, v.alive, L.o, L.d, L.c, L.med, v.cj1,
                           v.cj2, w);
          left = L.alive > 0.5f ? left - 1 : 0;
        });
  }
  cnt.flush();
  wave_store<true>(p, lane, L);
}

// K4's slice-rows per group: each thread of K4 holds this many
// independent 16-byte loads in flight
#define PERM_ROWS 8

// 16 bytes from and to 16-byte aligned addresses: one vector load and
// store on the card, both streaming (evict-first: the state is read and
// written once)
__device__ __forceinline__ float4 perm_load(const float* __restrict__ p) {
#ifdef __CUDACC__
  return __ldcs(reinterpret_cast<const float4*>(p));
#else
  return load4(p);
#endif
}

__device__ __forceinline__ void perm_store(float* __restrict__ p, float4 v) {
#ifdef __CUDACC__
  __stcs(reinterpret_cast<float4*>(p), v);
#else
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
  p[3] = v.w;
#endif
}

// K4 for lane t (0..31) of the warp that moves rows [r0, r1) of slice j:
// of each slice-row (128 lanes, 512 bytes) the 16 bytes at lanes 4t ..
// 4t + 3; rows [0, W_SORT_PAD) from slice `src` (perm[j]), the AOV rows
// from slice j. The rows go PERM_ROWS at a time, all of a group's loads
// before its stores.
__device__ __forceinline__ void permute_slice(const float* __restrict__ in,
                                              int src, size_t n_pad, int j,
                                              int t, int r0, int r1,
                                              float* __restrict__ out) {
  const size_t dst = (size_t)j * W_SLICE + 4 * t;
  const size_t from = (size_t)src * W_SLICE + 4 * t;
  for (int g = r0; g < r1; g += PERM_ROWS) {
    float4 v[PERM_ROWS];
#pragma unroll
    for (int i = 0; i < PERM_ROWS; ++i) {
      const int row = g + i;
      v[i] = perm_load(in + row * n_pad + (row < W_SORT_PAD ? from : dst));
    }
#pragma unroll
    for (int i = 0; i < PERM_ROWS; ++i)
      perm_store(out + (g + i) * n_pad + dst, v[i]);
  }
}

// The Sobol probe for lane i of n (the P-r3ac counterpart,
// scripts/tpu_session_r3ac.py:70-117): seven int32 rows of the input x,
// out[r * n + i]: the xor-shift pair, the add-multiply, the bit reversal,
// the Laine-Karras hash with seed 0x51633e2d, the dimension-2 Sobol value
// of x & 0xFFFF, and the two words of ld2_bits(x & 0xFFFF, key x).
__device__ __forceinline__ void probe_lane(const int* __restrict__ in, int n,
                                           int i, int* __restrict__ out) {
  const uint32_t x = (uint32_t)in[i];
  uint32_t w = x ^ (x << 13);
  w ^= w >> 7;
  uint32_t u, v;
  ld2_bits(x & 0xFFFFu, x, u, v);
  const uint32_t row[7] = {w, (x + 0x9E3779B9u) * 0x85EBCA6Bu, reverse32(x),
                           laine_karras(x, 0x51633E2Du),
                           sobol2_16(x & 0xFFFFu), u, v};
  for (int r = 0; r < 7; ++r) out[(size_t)r * n + i] = (int)row[r];
}
