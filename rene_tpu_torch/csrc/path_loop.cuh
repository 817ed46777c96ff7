// The path lane loop's step of K2's mesh variant (wave.cuh wave_lane),
// after the volpath lane loop's (vol_loop.cuh). A lane is a small state
// machine with one ray
// cast per step, from one call site (intersect.cuh cast_ray, so that the
// build holds one walk): the step casts the path ray (closest hit) or the
// shadow ray of the next queued distant light (any hit in [TMIN, 1e5]).
// After a closest cast it shades the bounce (`path_shade`): its draws, the
// background or the emitter hit, the AOVs at depth 0, each distant light's
// contribution, the BSDF step and the roulette, and queues the shadow rays
// of the lights that contribute. After a shadow cast it adds that light's
// contribution where the ray met nothing. When the bounce's last shadow
// ray is cast, or it queued none, the caller applies the bounce's verdict
// (K2: wave_tail's depth cut, next-launch key, regeneration or parking).
// So the lanes of a warp that need a walk, for whatever reason, walk
// together; the caller lets a warp's shadow rays go first (vol_loop.cuh
// step_now), so that its lanes shade together.
//
// A light's contribution, ((c * f) * |cos|) * colour, is computed at
// shade time, so that neither the material, the frame nor the hit is live
// across a cast; the sums go into the radiance in light order, each added
// where its ray met nothing, as in the bounce of the earlier design (a
// closest cast, then a shadow cast per light inside the bounce). A light
// whose contribution is zero in all three channels queues no ray: adding
// it changes no sum, which starts at +0 and so never holds -0. Past the
// first PATH_MAX_LIGHTS lights (a mesh scene's light table holds up to
// 1024) a light's contribution is computed after its ray, where it met
// nothing, from the hit kept in the queue's memory, as volpath.cuh
// nee_add does: every such light casts its ray. The draws,
// sums and casts that matter are the bounce's, in its order: a cast draws
// nothing, so drawing at shade time, after the cast, keeps the stream's
// sequence. Plain C++ apart from the CUDA qualifiers and intrinsics, so
// tests/test_torch_kernel_source.py and tests/test_torch_wave_path_lane.py
// compile it with g++ too.
#pragma once
#include <stdint.h>

#include "path.cuh"

// the lights whose contributions a bounce queues at shade time (the
// immediates' light cap, scene/pack.py MAX_LIGHTS); a queue of bits
#define PATH_MAX_LIGHTS 16
// where, past the queued contributions, the hit of a bounce with more
// lights is kept: its material, texture coordinates and shading normal
#define PATH_FAR_MAT (3 * PATH_MAX_LIGHTS)
#define PATH_FAR_U (PATH_FAR_MAT + 1)
#define PATH_FAR_V (PATH_FAR_MAT + 2)
#define PATH_FAR_N (PATH_FAR_MAT + 3)
#define PATH_SH_W (PATH_FAR_MAT + 6)

// Counts of K2's path lane loop, kept only by the -DMEGA_COUNT=1 build of
// the path mesh variant (`wave_path_mesh_count`, which `python -m
// rene_tpu_torch.probe --main-launches` alone launches): at the cast
// site, each warp's leader lane adds the lanes active there,
// __popc(__activemask()), and one warp cast; each thread counts its
// closest and shadow casts, the distant lights whose shadow ray it did not
// need, its bounces, whether its lane parked inside the launch, and the
// clock cycles inside its casts and in all. The sums go to loop_counts at
// the thread's end, in LOOP_KEYS' order (rene_tpu_torch/kernels.py).
#define N_LOOP_COUNTS 10
#if defined(MEGA_COUNT) && MEGA_COUNT
__device__ unsigned long long loop_counts[N_LOOP_COUNTS];
struct PathCounts {
  uint32_t active = 0, warp_casts = 0, closest = 0, shadow = 0,
           skipped = 0, bounces = 0, parked = 0;
  long long cast_cyc = 0, t0 = 0;
  __device__ PathCounts() { t0 = clock64(); }
  // at the cast site, before the cast; returns the clock
  __device__ __forceinline__ long long cast(bool is_shadow) {
    const unsigned am = __activemask();
    if ((threadIdx.x & 31u) == (unsigned)(__ffs(am) - 1)) {
      active += (uint32_t)__popc(am);
      warp_casts += 1u;
    }
    if (is_shadow) shadow += 1u;
    else closest += 1u;
    return clock64();
  }
  __device__ __forceinline__ void cast_end(long long c0) {
    cast_cyc += clock64() - c0;
  }
  __device__ __forceinline__ void bounce(int lights_skipped) {
    bounces += 1u;
    skipped += (uint32_t)lights_skipped;
  }
  __device__ __forceinline__ void park() { parked += 1u; }
  __device__ __forceinline__ void flush() {
    const unsigned long long v[N_LOOP_COUNTS] = {
        active, warp_casts, closest, shadow, skipped, bounces, 1ull, parked,
        (unsigned long long)cast_cyc, (unsigned long long)(clock64() - t0)};
    for (int i = 0; i < N_LOOP_COUNTS; ++i)
      if (v[i]) atomicAdd(&loop_counts[i], v[i]);
  }
};

// The counting build's loop counts: copied to the N_LOOP_COUNTS uint64
// words at `out` (device memory) on `stream`, then zeroed where `reset`;
// returns cudaGetLastError().
extern "C" int loop_counts_read(void* out, int reset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemcpyFromSymbolAsync(out, loop_counts, sizeof(loop_counts), 0,
                            cudaMemcpyDeviceToDevice, st);
  if (reset) {
    void* c = nullptr;
    cudaGetSymbolAddress(&c, loop_counts);
    cudaMemsetAsync(c, 0, sizeof(loop_counts), st);
  }
  return (int)cudaGetLastError();
}
#else
struct PathCounts {
  __device__ __forceinline__ long long cast(bool) { return 0; }
  __device__ __forceinline__ void cast_end(long long) {}
  __device__ __forceinline__ void bounce(int) {}
  __device__ __forceinline__ void park() {}
  __device__ __forceinline__ void flush() {}
};
#endif

// the lowest set bit's index (a queue of lights, lowest first)
__device__ __forceinline__ int low_bit(uint32_t m) {
#ifdef __CUDACC__
  return __ffs((int)m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// A lane's bounce under way: its verdict before the depth cut, its next
// origin, direction and throughput, its camera draws, and its queue of
// shadow rays: bit li of pend for distant light li < PATH_MAX_LIGHTS, with
// each one's contribution in the caller's array sh (PATH_SH_W floats),
// then lights far .. n_lights - 1 (the hit kept in sh past the
// contributions). sh is indexed by light, so it lies in local memory,
// which the L1 caches; it is kept apart from the struct, whose fields the
// compiler then holds in registers. The path ray itself (origin,
// direction, throughput) is the caller's until the bounce ends.
struct PathLoop {
  bool alive;
  V3 hp, w;
  float nthr[3];
  float cj1, cj2;
  uint32_t pend;
  int far;
};

// a loop before its first bounce
__device__ __forceinline__ void path_loop_start(const Scene& s,
                                                PathLoop& v) {
  v.pend = 0u;
  v.far = s.n_lights;
}

// whether the loop's next step is a shadow ray
__device__ __forceinline__ bool path_shadowing(const Scene& s,
                                               const PathLoop& v) {
  return v.pend != 0u || v.far < s.n_lights;
}

// light li's contribution at the hit: ((thr * f) * |cos|) * colour, the
// BSDF m at the frame f with normal n seen from lo
__device__ __forceinline__ void light_add(const Scene& s, bool beck, int li,
                                          const Mat& m, const Frame& f, V3 n,
                                          V3 lo, const float* thr,
                                          float* add) {
  const float* Lt = s.lights + li * LIGHT_W;
  const V3 ld = load3(Lt + LIGHT_DIR);
  const BsdfVal fe = bsdf_eval(m, lo, to_local(f, ld), beck);
  const float cosl = fabsf(ld.x * n.x + ld.y * n.y + ld.z * n.z);
  for (int c = 0; c < 3; ++c)
    add[c] = thr[c] * fe.f[c] * cosl * __ldg(Lt + LIGHT_COLOR + c);
}

// light li's contribution past the queued ones, from the hit kept in sh,
// the path ray's direction d and throughput thr
__device__ __forceinline__ void far_add(const Scene& s, bool beck, int li,
                                        const float* sh, V3 d,
                                        const float* thr, float* add) {
  Hit h{};
  h.mat = (int)sh[PATH_FAR_MAT];
  h.u = sh[PATH_FAR_U];
  h.v = sh[PATH_FAR_V];
  const Mat m = hit_material(s, h);
  const V3 n = v3(sh[PATH_FAR_N], sh[PATH_FAR_N + 1], sh[PATH_FAR_N + 2]);
  const Frame f = onb_from_w(n);
  light_add(s, beck, li, m, f, n, to_local(f, neg(d)), thr, add);
}

// The bounce of the ray (o, d) with throughput thr after its closest hit
// h, with its draws u: the background on a miss, else the emitter hit,
// the AOVs where `first` (depth 0), the lights' contributions queued in
// v and sh, the BSDF step and, where use_rr, the roulette past depth
// RR_START.
// Adds to the radiance sums rad and the AOV sums an, aa; v then holds the
// bounce's verdict and next ray. Returns the lights that queued no ray.
__device__ __forceinline__ int path_shade(const Scene& s, bool beck,
                                          bool use_rr, V3 o, V3 d,
                                          const float* thr, uint32_t depth,
                                          const Hit& h, const Draws& u,
                                          float* rad, float* an, float* aa,
                                          PathLoop& v, float* sh) {
  v.hp = o;
  v.w = d;
  for (int c = 0; c < 3; ++c) v.nthr[c] = thr[c];
  v.cj1 = u.cj1;
  v.cj2 = u.cj2;
  v.pend = 0u;
  v.far = s.n_lights;
  int skipped = 0;
  bool alive = h.t < BIG;
  if (!alive) {
    float bg[3];
    background(s.cam, s.atlas, bg_kind(s), d, bg);
    for (int c = 0; c < 3; ++c) rad[c] = rad[c] + thr[c] * bg[c];
  } else {
    const Mat m = hit_material(s, h);
    v.hp = v3(o.x + h.t * d.x, o.y + h.t * d.y, o.z + h.t * d.z);
    const V3 n = normalize3(h.n);
    const V3 wo = neg(d);
    const Frame f = onb_from_w(n);
    if ((h.e[0] != 0.f || h.e[1] != 0.f || h.e[2] != 0.f)
        && dot3(wo, n) > 0.f)
      for (int c = 0; c < 3; ++c) rad[c] = rad[c] + thr[c] * h.e[c];
    if (depth == 0u) {
      an[0] = an[0] + n.x;
      an[1] = an[1] + n.y;
      an[2] = an[2] + n.z;
      for (int c = 0; c < 3; ++c) aa[c] = aa[c] + m.ab[c];
    }
    const V3 lo = to_local(f, wo);
    const int near = s.n_lights < PATH_MAX_LIGHTS ? s.n_lights
                                                  : PATH_MAX_LIGHTS;
    for (int li = 0; li < near; ++li) {
      float add[3];
      light_add(s, beck, li, m, f, n, lo, thr, add);
      if (add[0] == 0.f && add[1] == 0.f && add[2] == 0.f) {
        skipped += 1;
        continue;
      }
      for (int c = 0; c < 3; ++c) sh[3 * li + c] = add[c];
      v.pend |= 1u << li;
    }
    if (near < s.n_lights) {
      v.far = near;
      sh[PATH_FAR_MAT] = (float)h.mat;  // a small row index: exact
      sh[PATH_FAR_U] = h.u;
      sh[PATH_FAR_V] = h.v;
      sh[PATH_FAR_N] = n.x;
      sh[PATH_FAR_N + 1] = n.y;
      sh[PATH_FAR_N + 2] = n.z;
    }
    alive = bsdf_step(s, m, f, n, lo, v.hp, u, beck, thr, v.w, v.nthr);
    // a throughput below the normal range counts as zero, as under the
    // flush-to-zero arithmetic of XLA and the TPU
    alive = alive
        && maxn(v.nthr[0], maxn(v.nthr[1], v.nthr[2])) >= FLT_MIN_NORMAL;
    if (use_rr) {
      const float p_cont =
          clampn(maxn(v.nthr[0], maxn(v.nthr[1], v.nthr[2])), 0.f, 1.f);
      const bool do_rr = depth > (uint32_t)RR_START;
      alive = alive && (!do_rr || u.rrv <= p_cont);
      if (do_rr && alive) {
        const float inv_p = 1.f / clamp_min(p_cont, 1e-20f);
        for (int c = 0; c < 3; ++c) v.nthr[c] = v.nthr[c] * inv_p;
      }
    }
  }
  v.alive = alive;
  return skipped;
}

// One step of the loop: the one cast, of the next queued shadow ray where
// `shadow` (path_shadowing), else of the path ray (o, d) with throughput
// thr, which the step then shades with its draws (at(): the Sobol pairs'
// sample index, pixel key and depth, taken there, after the cast); rays
// grows by ray_inc per bounce, the sums rad, an, aa as the bounce adds
// to them; sh is the queue's array. When the bounce and its shadow rays
// are done it calls done():
// v.alive is then the bounce's verdict before the depth cut, v.hp, v.w,
// v.nthr its next ray and v.cj1, v.cj2 its camera draws. cnt counts
// (PathCounts).
template <bool SOBOL, class At, class Done>
__device__ __forceinline__ void path_step(const Scene& s, bool beck,
                                          bool use_rr, PathLoop& v,
                                          float* sh, bool shadow, V3 o, V3 d,
                                          const float* thr, float& rays,
                                          float ray_inc, uint32_t& st,
                                          const At& at, float* rad,
                                          float* an, float* aa,
                                          PathCounts& cnt, const Done& done) {
  const int li = !shadow ? -1 : v.pend != 0u ? low_bit(v.pend) : v.far;
  V3 co = o, cd = d;
  if (shadow) {
    co = v.hp;
    cd = load3(s.lights + li * LIGHT_W + LIGHT_DIR);
  }
  const long long c0 = cnt.cast(shadow);
  const Hit h = cast_ray<true, true>(s, co, cd, TMIN, li, 1e5f);
  cnt.cast_end(c0);
  if (shadow) {
    if (li < PATH_MAX_LIGHTS) {
      if (!(h.t < BIG))
        for (int c = 0; c < 3; ++c) rad[c] = rad[c] + sh[3 * li + c];
      v.pend &= v.pend - 1u;
    } else {
      if (!(h.t < BIG)) {
        float add[3];
        far_add(s, beck, li, sh, d, thr, add);
        for (int c = 0; c < 3; ++c) rad[c] = rad[c] + add[c];
      }
      v.far = li + 1;
    }
  } else {
    rays = rays + ray_inc;
    const SobolAt a = at();
    const Draws u = draw_bounce_as<SOBOL>(s, use_rr, st, a);
    cnt.bounce(path_shade(s, beck, use_rr, o, d, thr, a.depth, h, u, rad,
                          an, aa, v, sh));
  }
  if (!path_shadowing(s, v)) done();
}
