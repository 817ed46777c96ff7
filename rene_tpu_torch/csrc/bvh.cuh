// Ray casts against the mesh BVHs and the sphere table (K1c, K1d).
// Mirrors rene_tpu_torch/ops/bvh.py. Replaces the JAX kernel's cluster
// march `mesh_closest` / `mesh_any` (pallas_path.py:2255, :2440) and its
// sphere-table march `sphere_closest` / `sphere_any` (:2636, :2663).
//
// Design. The TPU kernel marches every lane of a tile in lock-step over
// 128-triangle clusters behind box tables, because Mosaic has no per-lane
// gather. A CUDA thread gathers, so each thread walks its own binned-SAH
// BVH with a stack of BVH_STACK node indices in local memory, entering
// the nearer child first and testing leaf triangles with the JAX kernel's
// Möller-Trumbore (`_mt_test` :2148-2164) in the same operation order.
// Nodes are two float4 and triangle rows five, so a node costs two 16-byte
// loads. What bounds it: dependent loads down the tree (latency) and
// divergence between the threads of a warp; the tables of a 131k-triangle
// scene (~17 MB) sit in the 50 MB L2.
#pragma once
#include "layout.cuh"
#include "math.cuh"

struct MeshHit {
  float t, u, v;
  int prim;  // mesh row of the closest triangle, -1 if none
};

// 1 / d with |d| held above 1e-20, sign kept (_inv_dir :2057)
__device__ __forceinline__ float inv_guard(float x) {
  return 1.f / (fabsf(x) > 1e-20f ? x : (x >= 0.f ? 1e-20f : -1e-20f));
}

// slab test of the box (lo, hi); tn receives the entry distance
__device__ __forceinline__ bool box_enter(float4 lo, float4 hi, V3 o, V3 inv,
                                          float tmin, float tfar, float& tn) {
  float t0x = (lo.x - o.x) * inv.x, t1x = (hi.x - o.x) * inv.x;
  float t0y = (lo.y - o.y) * inv.y, t1y = (hi.y - o.y) * inv.y;
  float t0z = (lo.z - o.z) * inv.z, t1z = (hi.z - o.z) * inv.z;
  tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return fmaxf(tn, tmin) <= fminf(tf, tfar);
}

// Möller-Trumbore against mesh row r; the caller applies its t bounds
__device__ __forceinline__ bool mt_test(const float* __restrict__ r, V3 o,
                                        V3 d, float& t, float& u, float& v) {
  float4 a = load4(r), b = load4(r + 4), c = load4(r + 8);
  float v0x = a.x, v0y = a.y, v0z = a.z;
  float e1x = a.w, e1y = b.x, e1z = b.y;
  float e2x = b.z, e2y = b.w, e2z = c.x;
  float px = d.y * e2z - d.z * e2y;
  float py = d.z * e2x - d.x * e2z;
  float pz = d.x * e2y - d.y * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  float invd = 1.f / (fabsf(det) > 1e-12f ? det : 1e-12f);
  float tx = o.x - v0x, ty = o.y - v0y, tz = o.z - v0z;
  u = (tx * px + ty * py + tz * pz) * invd;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  v = (d.x * qx + d.y * qy + d.z * qz) * invd;
  t = (e2x * qx + e2y * qy + e2z * qz) * invd;
  return fabsf(det) > 1e-12f && u >= 0.f && v >= 0.f && u + v <= 1.f;
}

// Walk the BVH at node `root`. ANY: true at the first triangle hit in
// [tmin, tmax]. Otherwise keep the closest hit with tmin <= t < h.t in h.
template <bool ANY>
__device__ __forceinline__ bool bvh_march(const float* __restrict__ nodes,
                                          const float* __restrict__ mesh,
                                          int root, V3 o, V3 d, float tmin,
                                          float tmax, MeshHit& h) {
  V3 inv = v3(inv_guard(d.x), inv_guard(d.y), inv_guard(d.z));
  float tn;
  if (!box_enter(load4(nodes + root * NODE_W + NODE_LO),
                 load4(nodes + root * NODE_W + NODE_HI), o, inv, tmin,
                 ANY ? tmax : h.t, tn))
    return false;
  int stack[BVH_STACK];
  int sp = 0;
  int node = root;
  while (true) {
    float4 a = load4(nodes + node * NODE_W + NODE_LO);
    float4 b = load4(nodes + node * NODE_W + NODE_HI);
    bool go = false;
    if (b.w < 0.f) {
      int start = (int)a.w, end = start + (int)(-b.w);
      for (int k = start; k < end; ++k) {
        float t, u, v;
        if (!mt_test(mesh + (size_t)k * MESH_W, o, d, t, u, v)) continue;
        if (ANY) {
          if (t >= tmin && t <= tmax) return true;
        } else if (t >= tmin && t < h.t) {
          h.t = t;
          h.u = u;
          h.v = v;
          h.prim = k;
        }
      }
    } else {
      int l = (int)a.w, r = (int)b.w;
      float tfar = ANY ? tmax : h.t, tl, tr;
      bool hl = box_enter(load4(nodes + l * NODE_W + NODE_LO),
                          load4(nodes + l * NODE_W + NODE_HI), o, inv, tmin,
                          tfar, tl);
      bool hr = box_enter(load4(nodes + r * NODE_W + NODE_LO),
                          load4(nodes + r * NODE_W + NODE_HI), o, inv, tmin,
                          tfar, tr);
      if (hl && hr) {
        bool lfirst = tl <= tr;
        node = lfirst ? l : r;
        if (sp < BVH_STACK) stack[sp++] = lfirst ? r : l;
        go = true;
      } else if (hl || hr) {
        node = hl ? l : r;
        go = true;
      }
    }
    if (!go) {
      if (sp == 0) break;
      node = stack[--sp];
    }
  }
  return false;
}

// a ray in an instance's object space (its w2o; d is not renormalized, so
// t stays the world t)
__device__ __forceinline__ void to_object(const float* __restrict__ m, V3 o,
                                          V3 d, V3& lo, V3& ld) {
  lo = v3(__ldg(m + 0) * o.x + __ldg(m + 1) * o.y + __ldg(m + 2) * o.z
              + __ldg(m + 3),
          __ldg(m + 4) * o.x + __ldg(m + 5) * o.y + __ldg(m + 6) * o.z
              + __ldg(m + 7),
          __ldg(m + 8) * o.x + __ldg(m + 9) * o.y + __ldg(m + 10) * o.z
              + __ldg(m + 11));
  ld = v3(__ldg(m + 0) * d.x + __ldg(m + 1) * d.y + __ldg(m + 2) * d.z,
          __ldg(m + 4) * d.x + __ldg(m + 5) * d.y + __ldg(m + 6) * d.z,
          __ldg(m + 8) * d.x + __ldg(m + 9) * d.y + __ldg(m + 10) * d.z);
}

// centre/radius test of table slot r (_sph_test :2620): t is BIG where no
// root >= tmin; false unless the ray meets the sphere. disc subtracts two
// near-equal squares for a far sphere, so hb, c2 and disc are rounded
// step by step as the plain version rounds them.
__device__ __forceinline__ bool sph_test(float4 c, V3 o, V3 d, float tmin,
                                         float& t) {
  float ocx = o.x - c.x, ocy = o.y - c.y, ocz = o.z - c.z;
  float hb = add_rn(add_rn(mul_rn(ocx, d.x), mul_rn(ocy, d.y)),
                    mul_rn(ocz, d.z));
  float c2 = sub_rn(add_rn(add_rn(mul_rn(ocx, ocx), mul_rn(ocy, ocy)),
                           mul_rn(ocz, ocz)),
                    mul_rn(c.w, c.w));
  float disc = sub_rn(mul_rn(hb, hb), c2);
  float sq = sqrtf(clamp_min(disc, 0.f));
  float r0 = -hb - sq, r1 = -hb + sq;
  t = r0 >= tmin ? r0 : (r1 >= tmin ? r1 : BIG);
  return disc >= 0.f && c.w > 0.f;
}

// The sphere table, block by block behind each block's box. ANY: true at
// the first sphere hit in [tmin, tmax]. Otherwise the closest slot with
// t < t_best goes to `slot` and t_best.
template <bool ANY>
__device__ __forceinline__ bool sphere_table(const float* __restrict__ tab,
                                             const float* __restrict__ box,
                                             int n_blocks, V3 o, V3 d,
                                             float tmin, float tmax,
                                             float& t_best, int& slot) {
  V3 inv = v3(inv_guard(d.x), inv_guard(d.y), inv_guard(d.z));
  for (int b = 0; b < n_blocks; ++b) {
    float tn;
    if (!box_enter(load4(box + b * BOX_W + BOX_LO),
                   load4(box + b * BOX_W + BOX_HI), o, inv, tmin,
                   ANY ? tmax : t_best, tn))
      continue;
    for (int k = b * SPH_BLOCK; k < (b + 1) * SPH_BLOCK; ++k) {
      float t;
      if (!sph_test(load4(tab + k * SPHT_W + SPHT_C), o, d, tmin, t))
        continue;
      if (ANY) {
        if (t <= tmax) return true;
      } else if (t < t_best) {
        t_best = t;
        slot = k;
      }
    }
  }
  return false;
}
