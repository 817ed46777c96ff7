// One bounce of the volumetric path tracer (K1e), run by the megakernel's
// lane loop (mega_lane.cuh) and K2 (wave.cuh) in their -DMEGA_VOL=1
// builds. Mirrors rene_tpu_torch/integrators/volpath.py `bounce_vol`,
// which mirrors the JAX megakernel's `body_vol` (pallas_path.py:4572-4841).
// Plain C++ apart from the CUDA qualifiers and intrinsics.
//
// A bounce: the closest hit (the background on a miss); distance
// sampling in the lane's medium up to the hit; at a scatter point,
// Henyey-Greenstein NEE to every distant light and, with emitters, one
// emitter sample, each through the transmittance march (medium.cuh), then
// the phase-sampled direction; at a surface, the one-sided emitter hit,
// the AOVs at depth 0, distant-light NEE through the march and the path
// body's BSDF step (path.cuh bsdf_step), or, at a None surface,
// the ray passing on. The medium switches at every surface. No Russian
// roulette.
#pragma once
#include <stdint.h>

#include "medium.cuh"
#include "path.cuh"

// A volpath bounce's draws, in the stream contract's order: med_sample's
// two, med_sample_p's two, ue1..ue4 of the scatter point's emitter NEE
// when the scene has emitters, then the path body's draws without rrv.
// All of them on every bounce, before the ray casts (see Draws). Under
// Sobol the path body's draws are Sobol pairs at `at` (draw_bounce_sobol)
// and the stream keeps the others, in the same order (pallas_path.py
// :3315-3316, :3346-3347, :4635-4638).
struct VolDraws {
  float u_ch, u_d, up0, up1;
  float me1, me2, me3, me4;
  Draws u;
};

template <bool SOBOL>
__device__ __forceinline__ VolDraws draw_bounce_vol(const Scene& s,
                                                    uint32_t& st,
                                                    const SobolAt& at) {
  VolDraws v;
  v.u_ch = uniform(st);
  v.u_d = uniform(st);
  v.up0 = uniform(st);
  v.up1 = uniform(st);
  v.me1 = v.me2 = v.me3 = v.me4 = 0.f;
  if (s.n_eo > 0) {
    v.me1 = uniform(st);
    v.me2 = uniform(st);
    v.me3 = uniform(st);
    v.me4 = uniform(st);
  }
  v.u = draw_bounce_as<SOBOL>(s, false, st, at);
  return v;
}

// what a bounce hands on: whether the path goes on (before the depth
// cut), its next ray, throughput and medium, and the camera draws of a
// regenerated path
struct VolStep {
  bool alive;
  V3 o, d;
  float c[3];
  float med;
  float cj1, cj2;
};

// One volpath bounce of the ray (o, d) with throughput thr in medium
// med; adds to the radiance sums rad and, where `first` (depth 0), to
// the AOV sums. SOBOL: the path body's draws are Sobol pairs at `at`.
template <bool MESH, bool SOBOL>
__device__ __forceinline__ VolStep vol_bounce(const Scene& s,
                                              const Media& md, bool beck,
                                              V3 o, V3 d, const float* thr,
                                              float med, bool first,
                                              float* rad, float* an,
                                              float* aa, uint32_t& st,
                                              const SobolAt& at) {
  const int E = s.n_eo;
  const VolDraws v = draw_bounce_vol<SOBOL>(s, st, at);
  VolStep r;
  r.cj1 = v.u.cj1;
  r.cj2 = v.u.cj2;
  r.alive = false;
  r.o = o;
  r.d = d;
  r.med = med;
  Hit h = trace_closest<MESH>(s, o, d, TMIN);
  if (!(h.t < BIG)) {
    float bg[3];
    background(s.cam, s.atlas, (int)__ldg(s.cam + CAM_BG_KIND), d, bg);
    for (int c = 0; c < 3; ++c) rad[c] = rad[c] + thr[c] * bg[c];
    for (int c = 0; c < 3; ++c) r.c[c] = thr[c];
    return r;
  }
  const Med m = med_consts(md, med);
  const MedSample ms = med_sample(m, h.t, v.u_ch, v.u_d);
  for (int c = 0; c < 3; ++c) r.c[c] = thr[c] * ms.w[c];
  const V3 wo = neg(d);
  if (ms.sampled) {
    // a scatter point in the medium
    const V3 mp = v3(o.x + ms.t * d.x, o.y + ms.t * d.y, o.z + ms.t * d.z);
    for (int li = 0; li < s.n_lights; ++li) {
      const float* L = s.lights + li * LIGHT_W;
      const V3 ld = load3(L + LIGHT_DIR);
      const V3 trv = tr_march<MESH>(s, md, mp, ld, med, false);
      const float ph = med_phase(m, wo.x * ld.x + wo.y * ld.y + wo.z * ld.z);
      rad[0] = rad[0] + r.c[0] * trv.x * ph * __ldg(L + LIGHT_COLOR);
      rad[1] = rad[1] + r.c[1] * trv.y * ph * __ldg(L + LIGHT_COLOR + 1);
      rad[2] = rad[2] + r.c[2] * trv.z * ph * __ldg(L + LIGHT_COLOR + 2);
    }
    if (E > 0) {
      // one emitter sample, without MIS
      const V3 ls = sample_emit(s, mp, v.me1, v.me2, v.me3, v.me4);
      const float epdf = trace_emit_pdf(s, mp, ls) / (float)E;
      if (epdf > 1e-5f) {
        const V3 tre = tr_march<MESH>(s, md, mp, ls, med, true);
        const float phe = med_phase(m, wo.x * ls.x + wo.y * ls.y
                                           + wo.z * ls.z)
            / clamp_min(epdf, 1e-5f);
        rad[0] = rad[0] + r.c[0] * tre.x * phe;
        rad[1] = rad[1] + r.c[1] * tre.y * phe;
        rad[2] = rad[2] + r.c[2] * tre.z * phe;
      }
    }
    r.o = mp;
    r.d = med_sample_p(m, wo, v.up0, v.up1);
    r.alive = true;
  } else {
    // a surface
    const Mat mt = hit_material(s, h);
    const V3 hp = v3(o.x + h.t * d.x, o.y + h.t * d.y, o.z + h.t * d.z);
    const V3 n = normalize3(h.n);
    const float won = dot3_rn(wo, n);
    if ((h.e[0] != 0.f || h.e[1] != 0.f || h.e[2] != 0.f) && won > 0.f)
      for (int c = 0; c < 3; ++c) rad[c] = rad[c] + r.c[c] * h.e[c];
    if (first) {
      an[0] = an[0] + n.x;
      an[1] = an[1] + n.y;
      an[2] = an[2] + n.z;
      for (int c = 0; c < 3; ++c) aa[c] = aa[c] + mt.ab[c];
    }
    const float* slot = s.mats + h.mat * MAT_W;
    r.med = won < 0.f ? __ldg(slot + MAT_EMED) : __ldg(slot + MAT_IMED);
    r.o = hp;
    if (mt.type == MAT_NONE) {
      r.alive = true;  // passes through: direction and throughput stay
    } else {
      const Frame f = onb_from_w(n);
      const V3 lo = to_local(f, wo);
      for (int li = 0; li < s.n_lights; ++li) {
        const float* L = s.lights + li * LIGHT_W;
        const V3 ld = load3(L + LIGHT_DIR);
        const V3 trv = tr_march<MESH>(s, md, hp, ld, med, false);
        const BsdfVal fe = bsdf_eval(mt, lo, to_local(f, ld), beck);
        const float cosl = fabsf(ld.x * n.x + ld.y * n.y + ld.z * n.z);
        rad[0] = rad[0] + r.c[0] * trv.x * fe.f[0] * cosl * __ldg(L + LIGHT_COLOR);
        rad[1] = rad[1] + r.c[1] * trv.y * fe.f[1] * cosl
            * __ldg(L + LIGHT_COLOR + 1);
        rad[2] = rad[2] + r.c[2] * trv.z * fe.f[2] * cosl
            * __ldg(L + LIGHT_COLOR + 2);
      }
      r.alive = bsdf_step(s, mt, f, n, lo, hp, v.u, beck, r.c, r.d, r.c);
    }
  }
  // a throughput below the normal range counts as zero, as under the
  // flush-to-zero arithmetic of XLA and the TPU
  r.alive = r.alive && maxn(r.c[0], maxn(r.c[1], r.c[2])) >= FLT_MIN_NORMAL;
  return r;
}
