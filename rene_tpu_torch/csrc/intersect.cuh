// Ray casts of the path megakernel. Mirrors
// rene_tpu_torch/ops/intersect.py (pallas_path.py:2775-3279): brute-force
// loops over the immediate triangles and spheres, where the first
// primitive with the smallest t wins (strict less), triangles before
// spheres; then, in the MESH variant, one walk over the world mesh, the
// shared-BLAS instances and the sphere table (bvh.cuh `walk`) from the
// immediates' closest t, replacing their hit only where closer (at an
// equal t the immediates keep it). Where the scene has a
// textured material (Scene::has_tex) the closest hit also carries its
// texture coordinates: interpolated from a triangle's vertices, spherical
// on a sphere, none on a table sphere, whose material is solid.
#pragma once
#include <stdint.h>

#include "bvh.cuh"
#include "layout.cuh"
#include "math.cuh"
#include "texture.cuh"


// Plücker side values of the ray (moment w = o x d) against triangle row r
__device__ __forceinline__ float tri_side(const float* __restrict__ r, int m,
                                          int e, V3 d, V3 w) {
  return (d.x * __ldg(r + m) + d.y * __ldg(r + m + 1) + d.z * __ldg(r + m + 2))
      + (w.x * __ldg(r + e) + w.y * __ldg(r + e + 1) + w.z * __ldg(r + e + 2));
}

__device__ __forceinline__ bool side_ok(float s0, float s1, float s2,
                                        float dn) {
  bool side = (s0 >= 0 && s1 >= 0 && s2 >= 0) || (s0 <= 0 && s1 <= 0 && s2 <= 0);
  return side && fabsf(dn) > 1e-12f;
}

__device__ __forceinline__ float plane_t(const float* __restrict__ r, V3 o,
                                         float dn) {
  return (__ldg(r + TRI_PK) - (o.x * __ldg(r + TRI_PN)
                               + o.y * __ldg(r + TRI_PN + 1)
                               + o.z * __ldg(r + TRI_PN + 2)))
      / (fabsf(dn) > 1e-12f ? dn : 1e-12f);
}

__device__ __forceinline__ float w2o(const float* __restrict__ r, int i, int k) {
  return __ldg(r + SPH_W2O + 4 * i + k);
}

// ray in a sphere's object space
__device__ __forceinline__ void sphere_local(const float* __restrict__ r,
                                             V3 o, V3 d, V3& lo, V3& ld) {
  lo = v3(w2o(r, 0, 0) * o.x + w2o(r, 0, 1) * o.y + w2o(r, 0, 2) * o.z
              + w2o(r, 0, 3),
          w2o(r, 1, 0) * o.x + w2o(r, 1, 1) * o.y + w2o(r, 1, 2) * o.z
              + w2o(r, 1, 3),
          w2o(r, 2, 0) * o.x + w2o(r, 2, 1) * o.y + w2o(r, 2, 2) * o.z
              + w2o(r, 2, 3));
  ld = v3(w2o(r, 0, 0) * d.x + w2o(r, 0, 1) * d.y + w2o(r, 0, 2) * d.z,
          w2o(r, 1, 0) * d.x + w2o(r, 1, 1) * d.y + w2o(r, 1, 2) * d.z,
          w2o(r, 2, 0) * d.x + w2o(r, 2, 1) * d.y + w2o(r, 2, 2) * d.z);
}

// nearest root >= tmin of the unit sphere, BIG where none; the
// discriminant's sums rounded step by step (mul_rn), as in the sphere
// table's test: it cancels near a silhouette, where an FMA moves the root
// and the first-hit normal by ~1e-4
__device__ __forceinline__ float sphere_t(V3 lo, V3 ld, float tmin) {
  float a = add_rn(add_rn(mul_rn(ld.x, ld.x), mul_rn(ld.y, ld.y)),
                   mul_rn(ld.z, ld.z));
  float half_b = add_rn(add_rn(mul_rn(lo.x, ld.x), mul_rn(lo.y, ld.y)),
                        mul_rn(lo.z, ld.z));
  float c = sub_rn(add_rn(add_rn(mul_rn(lo.x, lo.x), mul_rn(lo.y, lo.y)),
                          mul_rn(lo.z, lo.z)), 1.f);
  float disc = sub_rn(mul_rn(half_b, half_b), mul_rn(a, c));
  float sq = sqrtf(clamp_min(disc, 0.f));
  float inv_a = 1.f / clamp_min(a, 1e-20f);
  float r0 = (-half_b - sq) * inv_a;
  float r1 = (-half_b + sq) * inv_a;
  bool okd = disc >= 0.f;
  return (okd && r0 >= tmin) ? r0 : ((okd && r1 >= tmin) ? r1 : BIG);
}

struct Hit {
  float t;
  V3 n;        // interpolated shading normal, not normalized
  float e[3];  // emitted radiance (0 unless an emitter)
  int mat;
  float u, v;  // texture coordinates, where Scene::has_tex
  // what was hit: the part (bvh.cuh PART_IMM, PART_WORLD, PART_INST +
  // instance, then the sphere table) and its row (immediate triangle,
  // n_tris + immediate sphere, mesh row or table slot); -1 on a miss
  int part, row;
};

template <bool MESH>
__device__ __forceinline__ Hit trace_closest(const Scene& s, V3 o, V3 d,
                                             float tmin) {
  V3 w = v3(o.y * d.z - o.z * d.y, o.z * d.x - o.x * d.z, o.x * d.y - o.y * d.x);
  float t_best = BIG;
  int best = -1;
  float b0 = 0.f, b1 = 0.f, b2 = 0.f;
  for (int i = 0; i < s.n_tris; ++i) {
    const float* r = s.tris + i * TRI_W;
    float dn = d.x * __ldg(r + TRI_PN) + d.y * __ldg(r + TRI_PN + 1)
        + d.z * __ldg(r + TRI_PN + 2);
    float t = plane_t(r, o, dn);
    if (!(t >= tmin && t < t_best)) continue;
    float s0 = tri_side(r, TRI_M0, TRI_E0, d, w);
    float s1 = tri_side(r, TRI_M1, TRI_E1, d, w);
    float s2 = tri_side(r, TRI_M2, TRI_E2, d, w);
    if (side_ok(s0, s1, s2, dn)) {
      t_best = t;
      best = i;
      b0 = s0;
      b1 = s1;
      b2 = s2;
    }
  }
  for (int k = 0; k < s.n_sph; ++k) {
    V3 lo, ld;
    sphere_local(s.sph + k * SPH_W, o, d, lo, ld);
    float t = sphere_t(lo, ld, tmin);
    if (t < t_best) {
      t_best = t;
      best = s.n_tris + k;
    }
  }
  Hit h;
  h.t = t_best;
  h.n = v3(0.f, 0.f, 0.f);
  h.e[0] = h.e[1] = h.e[2] = 0.f;
  h.mat = 0;
  h.u = h.v = 0.f;
  h.part = best < 0 ? -1 : PART_IMM;
  h.row = best;
  if constexpr (MESH) {
    // one walk over the mesh scene from the immediates' hit, which keeps
    // an equal t
    WalkHit wh;
    wh.t = t_best;
    wh.u = wh.v = 0.f;
    wh.part = h.part;
    wh.row = h.row;
    WalkCounts cnt;
    if (s.top >= 0) walk<false>(s, o, d, tmin, 0.f, wh, cnt);
    cnt.flush(0);
    if (wh.part == PART_INST + s.n_inst) {
      // table spheres: normal (hit - c) / r, never emissive
      const float4 c = load4(s.sph_tab + wh.row * SPHT_W + SPHT_C);
      const float invr = 1.f / (c.w > 0.f ? c.w : 1.f);
      h.t = wh.t;
      h.n = v3(sub_rn(add_rn(o.x, mul_rn(wh.t, d.x)), c.x) * invr,
               sub_rn(add_rn(o.y, mul_rn(wh.t, d.y)), c.y) * invr,
               sub_rn(add_rn(o.z, mul_rn(wh.t, d.z)), c.z) * invr);
      h.mat = (int)__ldg(s.sph_tab + wh.row * SPHT_W + SPHT_MAT);
      h.part = wh.part;
      h.row = wh.row;
      return h;
    }
    if (wh.part >= PART_WORLD) {
      // mesh triangles: normal n0 + u d1 + v d2, never emissive
      const float* r = s.mesh + (size_t)wh.row * MESH_W;
      V3 n = v3(__ldg(r + MESH_N0) + wh.u * __ldg(r + MESH_D1)
                    + wh.v * __ldg(r + MESH_D2),
                __ldg(r + MESH_N0 + 1) + wh.u * __ldg(r + MESH_D1 + 1)
                    + wh.v * __ldg(r + MESH_D2 + 1),
                __ldg(r + MESH_N0 + 2) + wh.u * __ldg(r + MESH_D1 + 2)
                    + wh.v * __ldg(r + MESH_D2 + 2));
      h.t = wh.t;
      h.mat = (int)__ldg(r + MESH_MAT);
      if (wh.part >= PART_INST) {
        // to world space as W2O^T n
        const float* m = s.insts + (wh.part - PART_INST) * INST_W;
        n = v3(__ldg(m + 0) * n.x + __ldg(m + 4) * n.y + __ldg(m + 8) * n.z,
               __ldg(m + 1) * n.x + __ldg(m + 5) * n.y + __ldg(m + 9) * n.z,
               __ldg(m + 2) * n.x + __ldg(m + 6) * n.y + __ldg(m + 10) * n.z);
        h.mat = (int)__ldg(m + INST_MAT);
      }
      h.n = n;
      if (s.has_tex && s.n_mesh_uv) {
        const float* q = s.mesh_uv + (size_t)wh.row * MESH_UV_W;
        h.u = __ldg(q) + wh.u * __ldg(q + 2) + wh.v * __ldg(q + 4);
        h.v = __ldg(q + 1) + wh.u * __ldg(q + 3) + wh.v * __ldg(q + 5);
      }
      h.part = wh.part;
      h.row = wh.row;
      return h;
    }
  }
  if (best < 0) return h;
  if (best < s.n_tris) {
    const float* r = s.tris + best * TRI_W;
    float denom = b0 + b1 + b2;
    denom = fabsf(denom) > 1e-30f ? denom : 1e-30f;
    float bu = b2 / denom;
    float bv = b0 / denom;
    float w0 = 1.f - bu - bv;
    h.n = v3(w0 * __ldg(r + TRI_N0) + bu * __ldg(r + TRI_N1) + bv * __ldg(r + TRI_N2),
             w0 * __ldg(r + TRI_N0 + 1) + bu * __ldg(r + TRI_N1 + 1)
                 + bv * __ldg(r + TRI_N2 + 1),
             w0 * __ldg(r + TRI_N0 + 2) + bu * __ldg(r + TRI_N1 + 2)
                 + bv * __ldg(r + TRI_N2 + 2));
    for (int c = 0; c < 3; ++c) h.e[c] = __ldg(r + TRI_EMIT + c);
    h.mat = (int)__ldg(r + TRI_MAT);
    if (s.has_tex) {
      h.u = w0 * __ldg(r + TRI_UV0) + bu * __ldg(r + TRI_UV1)
          + bv * __ldg(r + TRI_UV2);
      h.v = w0 * __ldg(r + TRI_UV0 + 1) + bu * __ldg(r + TRI_UV1 + 1)
          + bv * __ldg(r + TRI_UV2 + 1);
    }
  } else {
    const float* r = s.sph + (best - s.n_tris) * SPH_W;
    V3 lo, ld;
    sphere_local(r, o, d, lo, ld);
    V3 p = v3(lo.x + t_best * ld.x, lo.y + t_best * ld.y, lo.z + t_best * ld.z);
    // world normal = W2O^T p
    h.n = v3(w2o(r, 0, 0) * p.x + w2o(r, 1, 0) * p.y + w2o(r, 2, 0) * p.z,
             w2o(r, 0, 1) * p.x + w2o(r, 1, 1) * p.y + w2o(r, 2, 1) * p.z,
             w2o(r, 0, 2) * p.x + w2o(r, 1, 2) * p.y + w2o(r, 2, 2) * p.z);
    for (int c = 0; c < 3; ++c) h.e[c] = __ldg(r + SPH_EMIT + c);
    h.mat = (int)__ldg(r + SPH_MAT);
    if (s.has_tex) sphere_uv_of(p, h.u, h.v);
  }
  return h;
}

// any hit in [tmin, tmax] along distant light li; the light direction's
// dots with each immediate triangle's moments and plane normal come from
// the host
template <bool MESH>
__device__ __forceinline__ bool shadow_any(const Scene& s, int li, V3 o, V3 d,
                                           float tmin, float tmax) {
  V3 w = v3(o.y * d.z - o.z * d.y, o.z * d.x - o.x * d.z, o.x * d.y - o.y * d.x);
  const float* dots = s.light_dots + (size_t)li * s.n_tris * 4;
  for (int i = 0; i < s.n_tris; ++i) {
    const float* r = s.tris + i * TRI_W;
    const float* q = dots + 4 * i;
    float dn = __ldg(q + 3);
    float t = plane_t(r, o, dn);
    if (!(t >= tmin && t <= tmax)) continue;
    float s0 = __ldg(q) + (w.x * __ldg(r + TRI_E0) + w.y * __ldg(r + TRI_E0 + 1)
                           + w.z * __ldg(r + TRI_E0 + 2));
    float s1 = __ldg(q + 1) + (w.x * __ldg(r + TRI_E1) + w.y * __ldg(r + TRI_E1 + 1)
                               + w.z * __ldg(r + TRI_E1 + 2));
    float s2 = __ldg(q + 2) + (w.x * __ldg(r + TRI_E2) + w.y * __ldg(r + TRI_E2 + 1)
                               + w.z * __ldg(r + TRI_E2 + 2));
    if (side_ok(s0, s1, s2, dn)) return true;
  }
  for (int k = 0; k < s.n_sph; ++k) {
    V3 lo, ld;
    sphere_local(s.sph + k * SPH_W, o, d, lo, ld);
    if (sphere_t(lo, ld, tmin) <= tmax) return true;
  }
  if constexpr (MESH) {
    WalkHit unused;
    WalkCounts cnt;
    const bool hit =
        s.top >= 0 && walk<true>(s, o, d, tmin, tmax, unused, cnt);
    cnt.flush(1);
    if (hit) return true;
  }
  return false;
}

// solid-angle pdf of the emitter sampler for direction d: decided by the
// closest EMISSIVE primitive (occluders ignored), 0 where none is hit
__device__ __forceinline__ float trace_emit_pdf(const Scene& s, V3 o, V3 d) {
  V3 w = v3(o.y * d.z - o.z * d.y, o.z * d.x - o.x * d.z, o.x * d.y - o.y * d.x);
  V3 nd = normalize3(d);
  float t_best = BIG, pdf = 0.f;
  for (int j = 0; j < s.n_emit_tris; ++j) {
    const float* r = s.tris + __ldg(s.emit_tris + j) * TRI_W;
    float dn = d.x * __ldg(r + TRI_PN) + d.y * __ldg(r + TRI_PN + 1)
        + d.z * __ldg(r + TRI_PN + 2);
    float t = plane_t(r, o, dn);
    if (!(t >= TMIN && t < t_best)) continue;
    float s0 = tri_side(r, TRI_M0, TRI_E0, d, w);
    float s1 = tri_side(r, TRI_M1, TRI_E1, d, w);
    float s2 = tri_side(r, TRI_M2, TRI_E2, d, w);
    if (!side_ok(s0, s1, s2, dn)) continue;
    t_best = t;
    float dist2 = t * t * (d.x * d.x + d.y * d.y + d.z * d.z);
    float cosine = fabsf(nd.x * __ldg(r + TRI_GN) + nd.y * __ldg(r + TRI_GN + 1)
                         + nd.z * __ldg(r + TRI_GN + 2));
    pdf = dist2 / clamp_min(cosine * __ldg(r + TRI_AREA), 1e-20f)
        / __ldg(r + TRI_PRIMS);
  }
  for (int j = 0; j < s.n_emit_sph; ++j) {
    const float* r = s.sph + __ldg(s.emit_sph + j) * SPH_W;
    V3 lo, ld;
    sphere_local(r, o, d, lo, ld);
    float t = sphere_t(lo, ld, TMIN);
    if (!(t < t_best)) continue;
    t_best = t;
    float ex = __ldg(r + SPH_O2W + 3) - o.x;
    float ey = __ldg(r + SPH_O2W + 7) - o.y;
    float ez = __ldg(r + SPH_O2W + 11) - o.z;
    float d2 = ex * ex + ey * ey + ez * ez;
    float r2 = __ldg(r + SPH_R2);
    float cos_max = sqrtf(clamp_min(1.f - r2 / clamp_min(d2, 1e-20f), 0.f));
    pdf = d2 <= r2 ? (float)(1.0 / (4.0 * PI_D))
                   : 1.f / clamp_min(TWO_PI_F * (1.f - cos_max), 1e-20f);
  }
  return t_best < BIG ? pdf : 0.f;
}
