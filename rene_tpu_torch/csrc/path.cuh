// Per-lane pieces of the path kernels: camera, a bounce's draws, light
// sampling and the BSDF step with its MIS, shared by the megakernel's
// lane loop (mega_lane.cuh), the wave kernel (wave.cuh) and the volpath
// bounce (volpath.cuh). Mirrors
// rene_tpu_torch/integrators/{camera,common,mega_path}.py
// (pallas_path.py:3439-3493, :4140-4161, :4266-4570). Plain C++ apart
// from the CUDA qualifiers and intrinsics.
#pragma once
#include <stdint.h>

#include "bsdf.cuh"
#include "intersect.cuh"
#include "layout.cuh"
#include "math.cuh"
#include "sobol.cuh"
#include "texture.cuh"

#define FLT_MIN_NORMAL 1.17549435e-38f  // the least normal float32

// Where a path lane's clock cycles go, kept only by the -DPATH_COUNT=1
// build of the immediates megakernel (`mega_path_count`, which `python -m
// rene_tpu_torch.probe --scene cornell` alone launches): per thread, in a
// slot of shared memory, the cycles of its closest-hit casts
// (trace_closest), its emitter-pdf casts (trace_emit_pdf), its BSDF steps
// (bsdf_step: sample_light and the BSDF calls, the emitter-pdf casts
// inside them), its draws and its bounces; at its end the kernel adds
// them, the thread's cycles, and per warp the lane-bounces and 32 x the
// bounces of its busiest lane to path_counts (PATH_KEYS in
// rene_tpu_torch/kernels.py).
#define PH_TRACE 0
#define PH_EMIT 1
#define PH_BSDF 2
#define PH_DRAW 3
#define N_PHASES 4
#define N_PATH_COUNTS (N_PHASES + 4)
#if defined(PATH_COUNT) && PATH_COUNT
__device__ unsigned long long path_counts[N_PATH_COUNTS];
__shared__ long long path_cyc[N_PHASES][128];
__shared__ uint32_t path_bounces[128];
__device__ __forceinline__ long long path_clock() { return clock64(); }
__device__ __forceinline__ void path_add(int ph, long long t0) {
  path_cyc[ph][threadIdx.x] += clock64() - t0;
}
__device__ __forceinline__ void path_bounce() {
  path_bounces[threadIdx.x] += 1u;
}
__device__ __forceinline__ void path_begin() {
  for (int ph = 0; ph < N_PHASES; ++ph) path_cyc[ph][threadIdx.x] = 0;
  path_bounces[threadIdx.x] = 0u;
}
// every thread of the warp calls it; `ran` where it traced a lane
__device__ __forceinline__ void path_flush(long long t0, bool ran) {
  const long long total = clock64() - t0;
  const uint32_t b = ran ? path_bounces[threadIdx.x] : 0u;
  const uint32_t sum = __reduce_add_sync(0xffffffffu, b);
  const uint32_t mx = __reduce_max_sync(0xffffffffu, b);
  if (ran) {
    for (int ph = 0; ph < N_PHASES; ++ph)
      atomicAdd(path_counts + ph,
                (unsigned long long)path_cyc[ph][threadIdx.x]);
    atomicAdd(path_counts + N_PHASES, (unsigned long long)total);
    atomicAdd(path_counts + N_PHASES + 3, 1ull);
  }
  if ((threadIdx.x & 31u) == 0u) {
    atomicAdd(path_counts + N_PHASES + 1, (unsigned long long)sum);
    atomicAdd(path_counts + N_PHASES + 2, 32ull * mx);
  }
}
// The counting build's counts: copied to the N_PATH_COUNTS uint64 words
// at `out` (device memory) on `stream`, then zeroed where `reset`;
// returns cudaGetLastError().
extern "C" int path_counts_read(void* out, int reset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemcpyFromSymbolAsync(out, path_counts, sizeof(path_counts), 0,
                            cudaMemcpyDeviceToDevice, st);
  if (reset) {
    void* c = nullptr;
    cudaGetSymbolAddress(&c, path_counts);
    cudaMemsetAsync(c, 0, sizeof(path_counts), st);
  }
  return (int)cudaGetLastError();
}
#else
__device__ __forceinline__ long long path_clock() { return 0; }
__device__ __forceinline__ void path_add(int, long long) {}
__device__ __forceinline__ void path_bounce() {}
#endif

__device__ __forceinline__ float fjit(float u, float radius) {
  if (radius == 0.f) return u;
  float half = fminf(u, 1.f - u);
  float mag = 1.f - sqrtf(clamp_min(2.f * half, 0.f));
  return 0.5f + radius * (u < 0.5f ? -mag : mag);
}

__device__ __forceinline__ V3 camera_ray(const float* __restrict__ cam,
                                         float pxf, float pyf, float ju,
                                         float jv) {
  float r = __ldg(cam + CAM_FILTER);
  float u = (pxf + fjit(ju, r)) * __ldg(cam + CAM_INV_W1);
  float v = (pyf + fjit(jv, r)) * __ldg(cam + CAM_INV_H1);
  float nx = u * 2.f - 1.f;
  float ny = v * 2.f - 1.f;
  float tc[3], tw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* p = cam + CAM_PINV + 4 * k;
    tc[k] = __ldg(p) * nx + __ldg(p + 1) * ny + __ldg(p + 2) + __ldg(p + 3);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* c = cam + CAM_C2W + 4 * k;
    tw[k] = __ldg(c) * tc[0] + __ldg(c + 1) * tc[1] + __ldg(c + 2) * tc[2]
        + __ldg(c + 3);
  }
  return normalize3(v3(tw[0] - __ldg(cam + CAM_ORIGIN),
                       tw[1] - __ldg(cam + CAM_ORIGIN + 1),
                       tw[2] - __ldg(cam + CAM_ORIGIN + 2)));
}

// direction toward a sampled emitter point (pallas_path.py:3439)
__device__ __forceinline__ V3 sample_emit(const Scene& s, V3 p, float u_obj,
                                          float u_prim, float r, float sv) {
  bool flip = (r + sv) > 1.f;
  float rr = flip ? 1.f - r : r;
  float ss = flip ? 1.f - sv : sv;
  float w0 = 1.f - rr - ss;
  float eidx = floorf(u_obj * (float)(s.n_eo > 1 ? s.n_eo : 1));
  V3 q = v3(0.f, 0.f, 0.f), dir = v3(0.f, 0.f, 0.f);
  if (eidx < (float)s.n_eo) {
    const float* e = s.eo + (int)eidx * EO_W;
    if ((int)__ldg(e + EO_KIND) == KIND_TRIANGLE) {
      float cnt = __ldg(e + EO_COUNT);
      float pidx = floorf(u_prim * cnt);
      if (pidx < cnt) {
        const float* t = s.tris + (int)(__ldg(e + EO_START) + pidx) * TRI_W;
        q = v3(w0 * __ldg(t + TRI_V0) + rr * __ldg(t + TRI_V1)
                   + ss * __ldg(t + TRI_V2),
               w0 * __ldg(t + TRI_V0 + 1) + rr * __ldg(t + TRI_V1 + 1)
                   + ss * __ldg(t + TRI_V2 + 1),
               w0 * __ldg(t + TRI_V0 + 2) + rr * __ldg(t + TRI_V1 + 2)
                   + ss * __ldg(t + TRI_V2 + 2));
      }
    } else {
      V3 w = v3(__ldg(e + EO_CENTER) - p.x, __ldg(e + EO_CENTER + 1) - p.y,
                __ldg(e + EO_CENTER + 2) - p.z);
      float r2 = __ldg(e + EO_R2);
      float d2 = clamp_min(w.x * w.x + w.y * w.y + w.z * w.z, 1e-12f);
      float cos_max = sqrtf(clamp_min(1.f - r2 / d2, 0.f));
      float cos_t = d2 <= r2 ? 1.f - 2.f * r : 1.f - r * (1.f - cos_max);
      float sin_t = sqrtf(clamp_min(1.f - cos_t * cos_t, 0.f));
      float phi = TWO_PI_F * sv;
      w = normalize3(w);
      Frame f = onb_from_w(w);
      float cp = cosf(phi) * sin_t;
      float sp = sinf(phi) * sin_t;
      dir = v3(f.u.x * cp + f.v.x * sp + w.x * cos_t,
               f.u.y * cp + f.v.y * sp + w.y * cos_t,
               f.u.z * cp + f.v.z * sp + w.z * cos_t);
    }
  }
  if (!s.has_tri_emitter) return dir;
  V3 td = normalize3(v3(q.x - p.x, q.y - p.y, q.z - p.z));
  bool is_dir = dir.x != 0.f || dir.y != 0.f || dir.z != 0.f;
  return is_dir ? dir : td;
}

// The launch parameters `q` with a scene that runs no texture code: a
// kernel's instance without texture code (template parameter TEX false)
// traces through them, so that the compiler sees the scene's texture
// flags constant and leaves that code out.
template <typename Q>
__device__ __forceinline__ Q without_tex(Q q) {
  q.s.has_tex = q.s.has_env = q.s.tex = 0;
  return q;
}

// the kind of the scene's background (texture.cuh background): its own
// where the scene runs texture code, else the constant
__device__ __forceinline__ int bg_kind(const Scene& s) {
  return s.tex ? (int)__ldg(s.cam + CAM_BG_KIND) : BG_CONST;
}

// the hit's material, its textured slots evaluated at the hit's uv
__device__ __forceinline__ Mat hit_material(const Scene& s, const Hit& h) {
  Mat m = load_mat(s.mats, h.mat);
  if (s.has_tex) {
    const float* r = s.mats + h.mat * MAT_W;
    if (__ldg(r + MAT_NTEX) > 0.f) apply_textures(r, s.atlas, m, h.u, h.v);
  }
  return m;
}

// A bounce's draws, in the stream contract's order: u_coin, u1, u2, ul;
// coin, ue1..ue4 when the scene has emitters or an env-map strategy, then
// upick when it has both; rrv when Russian roulette is on; cj1, cj2. A
// bounce draws them all exactly once, whether or not a branch uses them,
// and before its ray casts: drawn after them (to free thirteen registers
// during the tree walk) the chain of dependent xorshift steps no longer
// overlaps the casts' memory latency, which measured 1.5-3% slower on an
// NVIDIA H100 (700 W).
struct Draws {
  float u_coin, u1, u2, ul;
  float coin, ue1, ue2, ue3, ue4, upick;
  float rrv, cj1, cj2;
};

__device__ __forceinline__ Draws draw_bounce(const Scene& s, bool use_rr,
                                             uint32_t& st) {
  Draws u;
  u.u_coin = uniform(st);
  u.u1 = uniform(st);
  u.u2 = uniform(st);
  u.ul = uniform(st);
  u.coin = u.ue1 = u.ue2 = u.ue3 = u.ue4 = u.upick = u.rrv = 0.f;
  if (s.n_eo > 0 || s.has_env) {
    u.coin = uniform(st);
    u.ue1 = uniform(st);
    u.ue2 = uniform(st);
    u.ue3 = uniform(st);
    u.ue4 = uniform(st);
    if (s.n_eo > 0 && s.has_env) u.upick = uniform(st);
  }
  if (use_rr) u.rrv = uniform(st);
  u.cj1 = uniform(st);
  u.cj2 = uniform(st);
  return u;
}

// The Sobol form of draw_bounce (`Sampler "sobol"`, pallas_path.py
// :4437-4523): the same draws, a pair per slot of decision `at`'s depth,
// (u1, u2) BSDF, (u_coin, ul) COIN; (ue1, ue2) NEE1, (ue3, ue4) NEE2 and
// (coin, upick) MISC when the scene has emitters or an env-map strategy;
// rrv RR. Nothing comes from the lane stream. The camera pair of a
// regenerated path is drawn by the caller, with the sample index after
// the finished path is counted.
__device__ __forceinline__ Draws draw_bounce_sobol(const Scene& s,
                                                   bool use_rr,
                                                   const SobolAt& at) {
  Draws u;
  ld2(at, SLOT_BSDF, u.u1, u.u2);
  ld2(at, SLOT_COIN, u.u_coin, u.ul);
  u.coin = u.ue1 = u.ue2 = u.ue3 = u.ue4 = u.upick = u.rrv = 0.f;
  if (s.n_eo > 0 || s.has_env) {
    ld2(at, SLOT_NEE1, u.ue1, u.ue2);
    ld2(at, SLOT_NEE2, u.ue3, u.ue4);
    ld2(at, SLOT_MISC, u.coin, u.upick);
  }
  if (use_rr) {
    float unused;
    ld2(at, SLOT_RR, u.rrv, unused);
  }
  u.cj1 = u.cj2 = 0.f;
  return u;
}

// a bounce's draws in the sampler of the kernel instance
template <bool SOBOL>
__device__ __forceinline__ Draws draw_bounce_as(const Scene& s, bool use_rr,
                                                uint32_t& st,
                                                const SobolAt& at) {
  if constexpr (SOBOL) return draw_bounce_sobol(s, use_rr, at);
  else return draw_bounce(s, use_rr, st);
}

// direction of the light sampler: an emit object, or the env map, picked
// with probability 1 / (E + 1) where the scene has both
__device__ __forceinline__ V3 sample_light(const Scene& s, V3 p,
                                           const Draws& u) {
  const int E = s.n_eo;
  if (s.has_env && (E == 0 || mul_rn(u.upick, (float)(E + 1)) < 1.f))
    return env_strategy(s.cam, s.env_mcdf, s.env_ccdf, s.env_guide, u.ue1,
                        u.ue2, u.ue3, u.ue4);
  return sample_emit(s, p, u.ue1, u.ue2, u.ue3, u.ue4);
}

// solid-angle pdf of sample_light for direction w
__device__ __forceinline__ float light_pdf(const Scene& s, V3 p, V3 w) {
  const int E = s.n_eo;
  const long long t0 = path_clock();
  float lp = E > 0 ? trace_emit_pdf(s, p, w) : 0.f;
  path_add(PH_EMIT, t0);
  if (s.has_env) lp = lp + env_pdf_dir(s.cam, s.env_pdf, w);
  return lp / (float)(E + (s.has_env ? 1 : 0));
}

// The BSDF step at a surface: the BSDF-sampled direction or, with
// emitters or an env map at a diffuse surface, one-sample MIS between
// the light and BSDF strategies. Writes the next direction to w and
// thr * f * |w . n| / pdf to nthr (which may be thr); returns whether
// pdf >= 1e-5.
__device__ __forceinline__ bool bsdf_step(const Scene& s, const Mat& m,
                                          const Frame& f, V3 n, V3 lo, V3 hp,
                                          const Draws& u, bool beck,
                                          const float* thr, V3& w,
                                          float* nthr) {
  const BsdfSample bs = bsdf_sample(m, lo, u.u_coin, u.u1, u.u2, u.ul, beck);
  w = to_world(f, bs.wi);
  float fv[3] = {bs.f[0], bs.f[1], bs.f[2]};
  float pdf = bs.pdf;
  if ((s.n_eo > 0 || s.has_env) && is_diffuse(m)) {
    const V3 ls = sample_light(s, hp, u);
    const BsdfVal fe = bsdf_eval(m, lo, to_local(f, ls), beck);
    float pdf_b = bs.pdf;
    if (u.coin > 0.5f) {
      w = ls;
      for (int c = 0; c < 3; ++c) fv[c] = fe.f[c];
      pdf_b = fe.pdf;
    }
    pdf = 0.5f * pdf_b + 0.5f * light_pdf(s, hp, w);
  }
  const float cosw = fabsf(w.x * n.x + w.y * n.y + w.z * n.z);
  const float scale = cosw / clamp_min(pdf, 1e-20f);
  for (int c = 0; c < 3; ++c) nthr[c] = thr[c] * fv[c] * scale;
  return pdf >= 1e-5f;
}
