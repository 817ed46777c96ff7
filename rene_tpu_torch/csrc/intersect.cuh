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
//
// Design (K1a). The TPU kernel bakes the immediates into its program. A
// CUDA thread loops over them, and every lane of a warp reads the same
// row at the same step: so the fields a cast reads sit in 16-byte-aligned
// cast rows (scene/pack.py imm_rows: per triangle the plane and the three
// Plücker moment and edge pairs in six float4, per sphere its
// world-to-object matrix in three), which each block copies into shared
// memory at its start (stage_imm); a 16-byte read of a row is then one
// broadcast, where the 55-float rows of `tris` took 22 scalar loads. The
// shading fields stay in `tris`, read for the winning hit and the emitter
// pdf only. Each triangle's three side tests come before its plane
// distance, so the division runs only where the ray crosses the
// triangle's lines: the same division of the same operands, so the same t
// bit for bit, and the same winner (the first in loop order at the least
// t). Measured on the card against the parent (PERF.md section 6): the
// rows by 16-byte reads of global memory, and the plane test first, ran
// slower.
#pragma once
#include <stdint.h>

#include "bvh.cuh"
#include "layout.cuh"
#include "math.cuh"
#include "texture.cuh"


// The immediates' cast rows (scene/pack.py imm_rows): the fields a cast
// reads, in 16-byte-aligned rows, which each kernel copies into shared
// memory at its start (stage_imm). Every lane of a warp reads the same
// row, so a 16-byte read of it is a broadcast. A host build reads the
// table itself.
#ifdef __CUDACC__
extern __shared__ float4 imm_shared[];
#endif

__device__ __forceinline__ const float* imm_rows(const Scene& s) {
#ifdef __CUDACC__
  (void)s;
  return reinterpret_cast<const float*>(imm_shared);
#else
  return s.imm;
#endif
}

// a float4 of a cast row
__device__ __forceinline__ float4 row4(const float* p) {
#ifdef __CUDACC__
  return *reinterpret_cast<const float4*>(p);
#else
  return load4(p);
#endif
}

// bytes of shared memory the cast rows of a scene take
#define IMM_BYTES(s) \
  (((size_t)(s).n_tris * IMM_TRI_W + (size_t)(s).n_sph * IMM_SPH_W) \
   * sizeof(float))

// Copy the cast rows into shared memory; every thread of the block calls
// it, first thing in the kernel.
__device__ __forceinline__ void stage_imm(const Scene& s) {
#ifdef __CUDACC__
  const int n = (int)(IMM_BYTES(s) / sizeof(float4));
  const float4* src = reinterpret_cast<const float4*>(s.imm);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    imm_shared[i] = __ldg(src + i);
  __syncthreads();
#else
  (void)s;
#endif
}

#ifdef __CUDACC__
// kernel<<<blocks, 128 threads, the scene's cast rows and `extra` bytes
// after them, stream>>>(args), the kernel first allowed that much shared
// memory where it passes the default 48 KB (the rows take at most 52 KB,
// at the immediates caps)
template <typename... A>
static void launch_staged_with(size_t extra, void (*kernel)(A...),
                               const Scene& s, int blocks, cudaStream_t st,
                               const A&... args) {
  const size_t smem = IMM_BYTES(s) + extra;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  kernel<<<blocks, 128, smem, st>>>(args...);
}

// the same with the cast rows alone
template <typename... A>
static void launch_staged(void (*kernel)(A...), const Scene& s, int blocks,
                          cudaStream_t st, const A&... args) {
  launch_staged_with(0, kernel, s, blocks, st, args...);
}
#endif

// Plücker side value of the ray (moment w = o x d) against moment m and
// edge e
__device__ __forceinline__ float tri_side(V3 m, V3 e, V3 d, V3 w) {
  return (d.x * m.x + d.y * m.y + d.z * m.z)
      + (w.x * e.x + w.y * e.y + w.z * e.z);
}

// the moments and edges of cast row r: five float4 from IMM_M0
struct ImmSides {
  float4 a, b, c, e, f;
  __device__ __forceinline__ V3 m0() const { return v3(a.x, a.y, a.z); }
  __device__ __forceinline__ V3 e0() const { return v3(a.w, b.x, b.y); }
  __device__ __forceinline__ V3 m1() const { return v3(b.z, b.w, c.x); }
  __device__ __forceinline__ V3 e1() const { return v3(c.y, c.z, c.w); }
  __device__ __forceinline__ V3 m2() const { return v3(e.x, e.y, e.z); }
  __device__ __forceinline__ V3 e2() const { return v3(e.w, f.x, f.y); }
};

__device__ __forceinline__ ImmSides imm_sides(const float* r) {
  return {row4(r + IMM_M0), row4(r + IMM_M0 + 4), row4(r + IMM_M0 + 8),
          row4(r + IMM_M0 + 12), row4(r + IMM_M0 + 16)};
}

__device__ __forceinline__ bool side_ok(float s0, float s1, float s2,
                                        float dn) {
  bool side = (s0 >= 0 && s1 >= 0 && s2 >= 0) || (s0 <= 0 && s1 <= 0 && s2 <= 0);
  return side && fabsf(dn) > 1e-12f;
}

// the distance to the plane pl = (pn, pk) along a ray with d . pn = dn
__device__ __forceinline__ float plane_t(float4 pl, V3 o, float dn) {
  return (pl.w - (o.x * pl.x + o.y * pl.y + o.z * pl.z))
      / (fabsf(dn) > 1e-12f ? dn : 1e-12f);
}

// ray in the object space of the sphere whose world-to-object rows are
// the three float4 at r
__device__ __forceinline__ void sphere_local(const float* r, V3 o, V3 d,
                                             V3& lo, V3& ld) {
  const float4 m0 = row4(r), m1 = row4(r + 4), m2 = row4(r + 8);
  lo = v3(m0.x * o.x + m0.y * o.y + m0.z * o.z + m0.w,
          m1.x * o.x + m1.y * o.y + m1.z * o.z + m1.w,
          m2.x * o.x + m2.y * o.y + m2.z * o.z + m2.w);
  ld = v3(m0.x * d.x + m0.y * d.y + m0.z * d.z,
          m1.x * d.x + m1.y * d.y + m1.z * d.z,
          m2.x * d.x + m2.y * d.y + m2.z * d.z);
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

// the result of an any-hit cast through cast_ray: t 0 where it met
// something, else BIG
__device__ __forceinline__ Hit shadow_hit(bool hit) {
  Hit h;
  h.t = hit ? 0.f : BIG;
  h.n = v3(0.f, 0.f, 0.f);
  h.e[0] = h.e[1] = h.e[2] = 0.f;
  h.mat = 0;
  h.u = h.v = 0.f;
  h.part = h.row = -1;
  return h;
}

// The closest hit of the ray (o, d) from tmin (trace_closest). Where
// EITHER and li >= 0, instead distant light li's shadow ray (shadow_any):
// whether the ray meets anything in [tmin, tmax], the result's t 0 where
// it does (shadow_hit); its immediates tested in shadow_any's arithmetic
// (the light's dots from the host), its walk the closest-hit one that
// ends at its first hit. So K2's path lane loop (path_loop.cuh) casts
// both kinds of ray from one call site, and its build holds one walk.
template <bool MESH, bool EITHER>
__device__ __forceinline__ Hit cast_ray(const Scene& s, V3 o, V3 d,
                                        float tmin, int li, float tmax) {
  const bool any = EITHER && li >= 0;
  V3 w = v3(o.y * d.z - o.z * d.y, o.z * d.x - o.x * d.z, o.x * d.y - o.y * d.x);
  float t_best = BIG;
  int best = -1;
  float b0 = 0.f, b1 = 0.f, b2 = 0.f;
  const float* rows = imm_rows(s);
  const float* dots = s.light_dots + (size_t)(any ? li : 0) * s.n_tris * 4;
  for (int i = 0; i < s.n_tris; ++i) {
    const float* r = rows + i * IMM_TRI_W;
    const float4 pl = row4(r + IMM_PN);
    float dn, s0, s1, s2;
    const ImmSides q = imm_sides(r);
    if (any) {
      const float4 dq = load4(dots + 4 * i);
      const V3 e0 = q.e0(), e1 = q.e1(), e2 = q.e2();
      dn = dq.w;
      s0 = dq.x + (w.x * e0.x + w.y * e0.y + w.z * e0.z);
      s1 = dq.y + (w.x * e1.x + w.y * e1.y + w.z * e1.z);
      s2 = dq.z + (w.x * e2.x + w.y * e2.y + w.z * e2.z);
    } else {
      dn = d.x * pl.x + d.y * pl.y + d.z * pl.z;
      s0 = tri_side(q.m0(), q.e0(), d, w);
      s1 = tri_side(q.m1(), q.e1(), d, w);
      s2 = tri_side(q.m2(), q.e2(), d, w);
    }
    if (!side_ok(s0, s1, s2, dn)) continue;
    float t = plane_t(pl, o, dn);
    if (any) {
      if (t >= tmin && t <= tmax) return shadow_hit(true);
      continue;
    }
    if (t >= tmin && t < t_best) {
      t_best = t;
      best = i;
      b0 = s0;
      b1 = s1;
      b2 = s2;
    }
  }
  const float* srows = rows + s.n_tris * IMM_TRI_W;
  for (int k = 0; k < s.n_sph; ++k) {
    V3 lo, ld;
    sphere_local(srows + k * IMM_SPH_W, o, d, lo, ld);
    float t = sphere_t(lo, ld, tmin);
    if (any) {
      if (t <= tmax) return shadow_hit(true);
      continue;
    }
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
    wh.t = any ? tmax : t_best;
    wh.u = wh.v = 0.f;
    wh.part = any ? 0x7FFFFFFF : h.part;
    wh.row = any ? 0x7FFFFFFF : h.row;
    WalkCounts cnt;
    bool hit = false;
    if (s.top >= 0) hit = walk<false, EITHER>(s, o, d, tmin, 0.f, wh, cnt, any);
    cnt.flush(any ? 1 : 0);
    if (any) return shadow_hit(hit);
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
    const float* c = srows + (best - s.n_tris) * IMM_SPH_W;
    V3 lo, ld;
    sphere_local(c, o, d, lo, ld);
    V3 p = v3(lo.x + t_best * ld.x, lo.y + t_best * ld.y, lo.z + t_best * ld.z);
    // world normal = W2O^T p
    const float4 m0 = row4(c), m1 = row4(c + 4), m2 = row4(c + 8);
    h.n = v3(m0.x * p.x + m1.x * p.y + m2.x * p.z,
             m0.y * p.x + m1.y * p.y + m2.y * p.z,
             m0.z * p.x + m1.z * p.y + m2.z * p.z);
    for (int c = 0; c < 3; ++c) h.e[c] = __ldg(r + SPH_EMIT + c);
    h.mat = (int)__ldg(r + SPH_MAT);
    if (s.has_tex) sphere_uv_of(p, h.u, h.v);
  }
  return h;
}

template <bool MESH>
__device__ __forceinline__ Hit trace_closest(const Scene& s, V3 o, V3 d,
                                             float tmin) {
  return cast_ray<MESH, false>(s, o, d, tmin, -1, 0.f);
}

// any hit in [tmin, tmax] along distant light li; the light direction's
// dots with each immediate triangle's moments and plane normal come from
// the host
template <bool MESH>
__device__ __forceinline__ bool shadow_any(const Scene& s, int li, V3 o, V3 d,
                                           float tmin, float tmax) {
  V3 w = v3(o.y * d.z - o.z * d.y, o.z * d.x - o.x * d.z, o.x * d.y - o.y * d.x);
  const float* dots = s.light_dots + (size_t)li * s.n_tris * 4;
  const float* rows = imm_rows(s);
  for (int i = 0; i < s.n_tris; ++i) {
    const float* r = rows + i * IMM_TRI_W;
    const float4 dq = load4(dots + 4 * i);
    float dn = dq.w;
    const ImmSides q = imm_sides(r);
    const V3 e0 = q.e0(), e1 = q.e1(), e2 = q.e2();
    float s0 = dq.x + (w.x * e0.x + w.y * e0.y + w.z * e0.z);
    float s1 = dq.y + (w.x * e1.x + w.y * e1.y + w.z * e1.z);
    float s2 = dq.z + (w.x * e2.x + w.y * e2.y + w.z * e2.z);
    if (!side_ok(s0, s1, s2, dn)) continue;
    float t = plane_t(row4(r + IMM_PN), o, dn);
    if (t >= tmin && t <= tmax) return true;
  }
  const float* srows = rows + s.n_tris * IMM_TRI_W;
  for (int k = 0; k < s.n_sph; ++k) {
    V3 lo, ld;
    sphere_local(srows + k * IMM_SPH_W, o, d, lo, ld);
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
  const float* rows = imm_rows(s);
  for (int j = 0; j < s.n_emit_tris; ++j) {
    const int i = __ldg(s.emit_tris + j);
    const float* c = rows + i * IMM_TRI_W;
    const float4 pl = row4(c + IMM_PN);
    float dn = d.x * pl.x + d.y * pl.y + d.z * pl.z;
    const ImmSides q = imm_sides(c);
    float s0 = tri_side(q.m0(), q.e0(), d, w);
    float s1 = tri_side(q.m1(), q.e1(), d, w);
    float s2 = tri_side(q.m2(), q.e2(), d, w);
    if (!side_ok(s0, s1, s2, dn)) continue;
    float t = plane_t(pl, o, dn);
    if (!(t >= TMIN && t < t_best)) continue;
    const float* r = s.tris + i * TRI_W;
    t_best = t;
    float dist2 = t * t * (d.x * d.x + d.y * d.y + d.z * d.z);
    float cosine = fabsf(nd.x * __ldg(r + TRI_GN) + nd.y * __ldg(r + TRI_GN + 1)
                         + nd.z * __ldg(r + TRI_GN + 2));
    pdf = dist2 / clamp_min(cosine * __ldg(r + TRI_AREA), 1e-20f)
        / __ldg(r + TRI_PRIMS);
  }
  const float* srows = rows + s.n_tris * IMM_TRI_W;
  for (int j = 0; j < s.n_emit_sph; ++j) {
    const int k = __ldg(s.emit_sph + j);
    const float* r = s.sph + k * SPH_W;
    V3 lo, ld;
    sphere_local(srows + k * IMM_SPH_W, o, d, lo, ld);
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
