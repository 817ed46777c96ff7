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
//
// Written as pieces: `vol_shade` shades a hit and queues its NEE marches
// (VolNee), `march_seg` (medium.cuh) advances a march by one closest hit,
// `nee_add` takes a finished march's sum. The lane loops of the
// megakernel and of K2 step them one ray cast at a time (vol_loop.cuh
// vol_step).
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

// A bounce's NEE marches, queued, each from the bounce's next origin (the
// scatter point or the surface hit): one per distant light, then, at a
// scatter point with emitters, the emitter sample's where its pdf
// exceeds 1e-5. The lane loop runs them one after another, one segment a
// step. The rest is what their sums need at their ends.
struct VolNee {
  float c[3];   // the throughput they weight: the medium's weight taken,
                // the BSDF step not yet
  V3 wo;        // toward the bounce ray's origin
  float med;    // the medium they start in, the bounce ray's
  V3 a;         // a surface's shading normal; a scatter point's emitter
                // sample direction
  float phe;    // a scatter point's emitter phase value over its pdf
  int mat;      // a surface's material; -1 at a scatter point
  float u, v;   // a surface's texture coordinates
  int n_march;  // marches queued
};

// direction of march q of the queue
__device__ __forceinline__ V3 nee_dir(const Scene& s, const VolNee& e,
                                      int q) {
  return q < s.n_lights ? load3(s.lights + q * LIGHT_W + LIGHT_DIR) : e.a;
}

// The NEE sums, each in the plain version's order (integrators/volpath.py
// bounce_vol): a distant light L at a scatter point, ((c * tr) * phase) *
// colour; the emitter sample, (c * tr) * (phase / pdf); a distant light
// at a surface, (((c * tr) * f) * |cos|) * colour.
__device__ __forceinline__ void add_scatter_light(float* rad, const float* c,
                                                  V3 tr, float ph,
                                                  const float* L) {
  rad[0] = rad[0] + c[0] * tr.x * ph * __ldg(L + LIGHT_COLOR);
  rad[1] = rad[1] + c[1] * tr.y * ph * __ldg(L + LIGHT_COLOR + 1);
  rad[2] = rad[2] + c[2] * tr.z * ph * __ldg(L + LIGHT_COLOR + 2);
}

__device__ __forceinline__ void add_scatter_emit(float* rad, const float* c,
                                                 V3 tr, float phe) {
  rad[0] = rad[0] + c[0] * tr.x * phe;
  rad[1] = rad[1] + c[1] * tr.y * phe;
  rad[2] = rad[2] + c[2] * tr.z * phe;
}

__device__ __forceinline__ void add_surface_light(float* rad, const float* c,
                                                  V3 tr, const BsdfVal& fe,
                                                  float cosl,
                                                  const float* L) {
  rad[0] = rad[0] + c[0] * tr.x * fe.f[0] * cosl * __ldg(L + LIGHT_COLOR);
  rad[1] = rad[1] + c[1] * tr.y * fe.f[1] * cosl * __ldg(L + LIGHT_COLOR + 1);
  rad[2] = rad[2] + c[2] * tr.z * fe.f[2] * cosl * __ldg(L + LIGHT_COLOR + 2);
}

// The end of march q of the queue `e`, whose transmittance is tr: its sum
// into rad. A surface's material and frame are evaluated again from the
// queue, so that the lane loop holds none of them while it marches.
__device__ __forceinline__ void nee_add(const Scene& s, const Media& md,
                                        bool beck, const VolNee& e, int q,
                                        V3 tr, float* rad) {
  if (e.mat < 0) {
    if (q < s.n_lights) {
      const float* L = s.lights + q * LIGHT_W;
      const V3 ld = load3(L + LIGHT_DIR);
      const float ph = med_phase(med_consts(md, e.med),
                                 e.wo.x * ld.x + e.wo.y * ld.y
                                     + e.wo.z * ld.z);
      add_scatter_light(rad, e.c, tr, ph, L);
    } else {
      add_scatter_emit(rad, e.c, tr, e.phe);
    }
    return;
  }
  const float* L = s.lights + q * LIGHT_W;
  const V3 ld = load3(L + LIGHT_DIR);
  Hit h{};
  h.mat = e.mat;
  h.u = e.u;
  h.v = e.v;
  const Mat mt = hit_material(s, h);
  const V3 n = e.a;
  const Frame f = onb_from_w(n);
  const BsdfVal fe = bsdf_eval(mt, to_local(f, e.wo), to_local(f, ld), beck);
  const float cosl = fabsf(ld.x * n.x + ld.y * n.y + ld.z * n.z);
  add_surface_light(rad, e.c, tr, fe, cosl, L);
}

// The volpath bounce of the ray (o, d) with throughput thr in medium med,
// after its closest hit h, with its draws v: the background on a miss;
// distance sampling; at a scatter point the NEE and the phase-sampled
// direction; at a surface the one-sided emitter hit, the AOVs where
// `first` (depth 0), the medium switch, the NEE and the BSDF step, or at
// a None surface the ray passing on. Adds to the radiance sums rad and
// the AOV sums an, aa. The NEE marches are queued in `e`, from the next
// ray's origin; nee_add takes their sums as they end, in queue order.
template <bool MESH>
__device__ __forceinline__ VolStep vol_shade(const Scene& s, const Media& md,
                                             bool beck, V3 o, V3 d,
                                             const float* thr, float med,
                                             bool first, const Hit& h,
                                             const VolDraws& v, float* rad,
                                             float* an, float* aa,
                                             VolNee& e) {
  const int E = s.n_eo;
  VolStep r;
  r.cj1 = v.u.cj1;
  r.cj2 = v.u.cj2;
  r.alive = false;
  r.o = o;
  r.d = d;
  r.med = med;
  e.n_march = 0;
  e.mat = -1;
  e.med = med;
  e.wo = neg(d);
  e.a = v3(0.f, 0.f, 0.f);
  e.phe = 0.f;
  e.u = e.v = 0.f;
  if (!(h.t < BIG)) {
    float bg[3];
    background(s.cam, s.atlas, bg_kind(s), d, bg);
    for (int c = 0; c < 3; ++c) rad[c] = rad[c] + thr[c] * bg[c];
    for (int c = 0; c < 3; ++c) r.c[c] = e.c[c] = thr[c];
    return r;
  }
  const Med m = med_consts(md, med);
  const MedSample ms = med_sample(m, h.t, v.u_ch, v.u_d);
  for (int c = 0; c < 3; ++c) r.c[c] = e.c[c] = thr[c] * ms.w[c];
  const V3 wo = neg(d);
  if (ms.sampled) {
    // a scatter point in the medium
    const V3 mp = v3(o.x + ms.t * d.x, o.y + ms.t * d.y, o.z + ms.t * d.z);
    e.n_march = s.n_lights;
    if (E > 0) {
      // one emitter sample, without MIS
      const V3 ls = sample_emit(s, mp, v.me1, v.me2, v.me3, v.me4);
      const float epdf = trace_emit_pdf(s, mp, ls) / (float)E;
      if (epdf > 1e-5f) {
        const float phe = med_phase(m, wo.x * ls.x + wo.y * ls.y
                                           + wo.z * ls.z)
            / clamp_min(epdf, 1e-5f);
        e.a = ls;
        e.phe = phe;
        e.n_march = e.n_march + 1;
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
      e.n_march = s.n_lights;
      e.mat = h.mat;
      e.u = h.u;
      e.v = h.v;
      e.a = n;
      r.alive = bsdf_step(s, mt, f, n, lo, hp, v.u, beck, r.c, r.d, r.c);
    }
  }
  // a throughput below the normal range counts as zero, as under the
  // flush-to-zero arithmetic of XLA and the TPU
  r.alive = r.alive && maxn(r.c[0], maxn(r.c[1], r.c[2])) >= FLT_MIN_NORMAL;
  return r;
}
