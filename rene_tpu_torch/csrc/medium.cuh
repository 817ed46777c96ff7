// Homogeneous media and the transmittance march of the volpath body
// (K1e). Mirrors rene_tpu_torch/ops/medium.py and ops/intersect.py
// `tr_march`, which mirror the JAX megakernel's `med_consts`, `med_tr`,
// `med_sample`, `med_phase`, `med_sample_p` (pallas_path.py:3287-3361)
// and `tr_march` (:3363-3430): the march as segments of one closest hit
// each (`march_seg`), which the lane loops of the megakernel and of K2
// step one at a time (vol_loop.cuh). Plain C++ apart from the
// CUDA qualifiers and intrinsics, so tests/test_torch_kernel_source.py
// compiles it with g++ too.
//
// A lane's medium is a float index into the (K, MED_W) media table; 0,
// an index the table does not hold and a vacuum row are vacuum. The
// products and sums behind a branch (the sampled distance against the
// segment, the sign of d . n that picks the next medium) are rounded
// step by step as torch rounds them, so that nvcc's multiply-add
// contraction sends no lane the other way.
#pragma once
#include <stdint.h>

#include "intersect.cuh"
#include "layout.cuh"
#include "math.cuh"

#define MAX_TR_MARCH 32

struct Media {
  const float* __restrict__ tab;  // (n, MED_W)
  int n;
};

struct Med {
  float st[3], ss[3], g;
  bool vac;
};

__device__ __forceinline__ Med med_consts(const Media& md, float med) {
  Med m;
  const int i = (int)med;
  const bool known = med >= 0.f && i < md.n && (float)i == med;
  const float* r = md.tab + (known ? i : 0) * MED_W;
  m.vac = !known || __ldg(r + MED_VAC) > 0.5f;
  for (int c = 0; c < 3; ++c) {
    m.st[c] = m.vac ? 0.f : __ldg(r + MED_ST + c);
    m.ss[c] = m.vac ? 0.f : __ldg(r + MED_SS + c);
  }
  m.g = m.vac ? 0.f : __ldg(r + MED_G);
  return m;
}

// transmittance along distance t; 1 in vacuum
__device__ __forceinline__ V3 med_tr(const Med& m, float t) {
  if (m.vac) return v3(1.f, 1.f, 1.f);
  return v3(expf(-m.st[0] * t), expf(-m.st[1] * t), expf(-m.st[2] * t));
}

struct MedSample {
  bool sampled;  // the lane scatters in its medium before t_max
  float t;       // distance to the scatter point (0 in vacuum)
  float w[3];    // throughput weight
};

// per-channel distance sampling along a segment of length t_max, from
// the draws u_ch (the channel) and u (the distance)
__device__ __forceinline__ MedSample med_sample(const Med& m, float t_max,
                                                float u_ch, float u) {
  MedSample r;
  if (m.vac) {
    r.sampled = false;
    r.t = 0.f;
    r.w[0] = r.w[1] = r.w[2] = 1.f;
    return r;
  }
  const float ch = floorf(mul_rn(u_ch, 3.f));
  const float sig = ch == 0.f ? m.st[0] : (ch == 1.f ? m.st[1] : m.st[2]);
  const float dist = -logf(clamp_min(1.f - u, 1e-10f)) / clamp_min(sig, 1e-20f);
  const bool sampled = dist < t_max;
  const float t = fminf(dist, t_max);
  float tr[3], dens[3];
  for (int c = 0; c < 3; ++c) {
    tr[c] = expf(-m.st[c] * t);
    dens[c] = sampled ? mul_rn(m.st[c], tr[c]) : tr[c];
  }
  float pdf = mul_rn(add_rn(add_rn(dens[0], dens[1]), dens[2]),
                     (float)(1.0 / 3.0));
  pdf = pdf == 0.f ? 1.f : pdf;
  for (int c = 0; c < 3; ++c)
    r.w[c] = (sampled ? mul_rn(tr[c], m.ss[c]) : tr[c]) / pdf;
  r.sampled = sampled;
  r.t = t;
  return r;
}

// Henyey-Greenstein phase value; 0 in vacuum
__device__ __forceinline__ float med_phase(const Med& m, float cos_theta) {
  if (m.vac) return 0.f;
  const float g = m.g;
  const float denom = 1.f + g * g + 2.f * g * cos_theta;
  return (float)(1.0 / (4.0 * PI_D)) * (1.f - g * g)
      / clamp_min(denom * sqrtf(clamp_min(denom, 1e-20f)), 1e-20f);
}

// a Henyey-Greenstein scatter direction about wo (isotropic where
// |g| < 1e-3) from the draws u0, u1
__device__ __forceinline__ V3 med_sample_p(const Med& m, V3 wo, float u0,
                                           float u1) {
  const float g = m.g;
  float cos_t;
  if (fabsf(g) < 1e-3f) {
    cos_t = 1.f - 2.f * u0;
  } else {
    const float sqr = (1.f - g * g) / clamp_min(1.f + g - 2.f * g * u0, 1e-9f);
    cos_t = -(1.f + g * g - sqr * sqr) / (fabsf(g) < 1e-9f ? 1e-9f : 2.f * g);
  }
  const float sin_t = sqrtf(clamp_min(1.f - cos_t * cos_t, 0.f));
  const float phi = TWO_PI_F * u1;
  const Frame f = onb_from_w(wo);
  const float cp = cosf(phi) * sin_t;
  const float sp = sinf(phi) * sin_t;
  return v3(f.u.x * cp + f.v.x * sp + wo.x * cos_t,
            f.u.y * cp + f.v.y * sp + wo.y * cos_t,
            f.u.z * cp + f.v.z * sp + wo.z * cos_t);
}

// a . b with each product and sum rounded on its own, as torch computes it
__device__ __forceinline__ float dot3_rn(V3 a, V3 b) {
  return add_rn(add_rn(mul_rn(a.x, b.x), mul_rn(a.y, b.y)), mul_rn(a.z, b.z));
}

// A transmittance march under way: its ray, the medium it is in, the
// transmittance so far and the segments walked.
struct March {
  V3 o, d;
  float med;
  float tr[3];
  int k;
};

__device__ __forceinline__ March march_start(V3 o, V3 d, float med) {
  March m;
  m.o = o;
  m.d = d;
  m.med = med;
  m.tr[0] = m.tr[1] = m.tr[2] = 1.f;
  m.k = 0;
  return m;
}

// One segment of the transmittance march from m.o along m.d, given that
// ray's closest hit h: up to MAX_TR_MARCH segments, passing through None
// surfaces into the surface's exterior medium where d leaves it (d . n >
// 0), else its interior. Returns true when the march ends, with its
// result in `out`: without want_emit a miss gives the transmittance so
// far and any other surface 0; with it, a front-facing emitter gives the
// transmittance times its radiance and the march stops at any emitter.
// Else m moves on to the surface's far side.
__device__ __forceinline__ bool march_seg(const Scene& s, const Media& md,
                                          March& m, const Hit& h,
                                          bool want_emit, V3& out) {
  out = v3(0.f, 0.f, 0.f);
  if (!(h.t < BIG)) {  // a miss
    if (!want_emit) out = v3(m.tr[0], m.tr[1], m.tr[2]);
    return true;
  }
  const float* r = s.mats + h.mat * MAT_W;
  const bool none = (int)__ldg(r + MAT_TYPE) == MAT_NONE;
  if (want_emit && (h.e[0] != 0.f || h.e[1] != 0.f || h.e[2] != 0.f)) {
    const V3 n = normalize3(h.n);
    if (-(m.d.x * n.x + m.d.y * n.y + m.d.z * n.z) > 0.f)
      out = v3(m.tr[0] * h.e[0], m.tr[1] * h.e[1], m.tr[2] * h.e[2]);
    return true;
  }
  if (!none) return true;
  const V3 seg = med_tr(med_consts(md, m.med), fminf(h.t, 1e20f));
  m.tr[0] = m.tr[0] * seg.x;
  m.tr[1] = m.tr[1] * seg.y;
  m.tr[2] = m.tr[2] * seg.z;
  m.med = dot3_rn(m.d, h.n) > 0.f ? __ldg(r + MAT_EMED) : __ldg(r + MAT_IMED);
  m.o = v3(m.o.x + h.t * m.d.x, m.o.y + h.t * m.d.y, m.o.z + h.t * m.d.z);
  return ++m.k == MAX_TR_MARCH;  // out stays 0
}
