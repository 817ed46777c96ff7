// Ray casts against the mesh scene (K1c, K1d): one walk over the world
// mesh, the shared-BLAS instances and the sphere table. Replaces the JAX
// kernel's cluster march `mesh_closest` / `mesh_any` (pallas_path.py
// :2255, :2440) and its sphere-table march `sphere_closest` /
// `sphere_any` (:2636, :2663); the plain version is
// rene_tpu_torch/ops/bvh.py, which walks the binary trees these come from.
//
// Design. The TPU kernel marches every lane of a tile in lock-step over
// 128-triangle clusters behind box tables, because Mosaic has no per-lane
// gather. A CUDA thread gathers, so each thread walks its own tree; the
// card has no ray-tracing cores. What bounds the walk, as measured
// (PERF.md section 6): its steps and their box tests, each a chain of
// dependent instructions, and the lanes of a warp that wait on each
// other; not the bytes it loads (8-bit child boxes, half the bytes, ran
// slower for their decoding). So (scene/accel.py `wide_tables`):
//
// * The binned-SAH binary BVHs are collapsed into 4-wide ones. A wide
//   node is one 128-byte row, eight float4: its children's boxes, one
//   float4 per coordinate, and their walk entries. A step loads the row
//   with eight independent loads and tests all four boxes at once, with
//   the slab arithmetic of the plain walk's box test (so a child is
//   entered exactly where the binary walk would enter it), orders the
//   entered children by entry distance with a five-exchange sorting
//   network (a closest-hit walk; an any-hit walk takes them in their
//   order), goes into the first and pushes the others, far first, with
//   their entry distance: a popped entry beyond the closest hit so far is
//   dropped without a load. About half the binary tree's levels, each
//   one dependent load instead of two.
// * The stack holds TRAVERSAL_STACK entries (walk entry, entry distance) in
//   local memory, which the L1 caches; the host checks the deepest a walk
//   may need. A slice of shared memory measured slower: its 16 KB a
//   block come out of the L1 that holds the nodes (PERF.md section 6).
// * A leaf's triangles are the binary leaf's, the same mesh rows; the
//   test reads the 48-byte rows of mesh_vt (v0, e1, e2) with the JAX
//   kernel's Moller-Trumbore (`_mt_test` :2148-2164) in the same
//   operation order, and the shading rows only for the winning hit.
// * One small wide tree on top holds the world BVH's root, each instance
//   behind a padded world box and each SPH_BLOCK-slot block of the sphere
//   table. At an instance the ray goes to object space, a marker goes on
//   the stack and the walk goes on in the instance's BLAS; popping the
//   marker brings back the world ray. So the nearest parts are walked
//   first and cut off the farther ones, and one loop, templated on
//   closest or any hit, is the whole cast: trace_closest and shadow_any
//   call it once each. K2's path lane loop casts both kinds from one call
//   site (path_loop.cuh), through the closest-hit loop that ends at its
//   first hit where the caller asks (template parameter EITHER), so that
//   its build holds one walk.
//
// The hit does not depend on the order of the walk: the least t wins; on
// an exact tie the lowest part (the immediates, the world mesh, the
// instances by row, the table spheres by slot), then the lowest mesh row
// or slot (`closer`), as in the plain version. Boxes are entered where
// t <= the closest so far, so a tie is always reached.
#pragma once
#include <stdint.h>

#include "layout.cuh"
#include "math.cuh"

// the parts of a mesh scene, in the order that breaks an exact tie in t;
// the sphere table is PART_INST + the number of instances
#define PART_IMM 0
#define PART_WORLD 1
#define PART_INST 2
// the scene's tables, as launch.cuh and wave_launch.cuh receive them
struct Scene {
  const float* __restrict__ tris;
  const float* __restrict__ sph;
  const float* __restrict__ mats;
  const float* __restrict__ eo;
  const int* __restrict__ emit_tris;
  const int* __restrict__ emit_sph;
  const float* __restrict__ lights;
  const float* __restrict__ light_dots;
  const float* __restrict__ cam;
  int n_tris, n_sph, n_eo, n_emit_tris, n_emit_sph, n_lights;
  int has_tri_emitter;
  // acceleration tables (scene/accel.py), read by the MESH variant only:
  // the mesh rows' shading data, the instances, the sphere table
  const float* __restrict__ mesh;
  const float* __restrict__ insts;
  const float* __restrict__ sph_tab;
  int n_inst;
  // textures (K1b): the uv rows of a textured mesh, the RGB9E5 atlas and
  // the env-map sampling tables
  const float* __restrict__ mesh_uv;
  const uint32_t* __restrict__ atlas;
  const float* __restrict__ env_mcdf;
  const float* __restrict__ env_ccdf;
  const float* __restrict__ env_pdf;
  int n_mesh_uv;  // rows of mesh_uv: 0 for a mesh of solid materials
  int has_tex;    // some material has a textured slot: hits carry uv
  int has_env;    // the env map is a light-sampling strategy
  // the scene runs texture code (textured materials, a textured
  // background or env-map sampling): 0 launches each kernel's instance
  // without it, which reads no background kind and holds no texture code
  int tex;
  // the walk's tables (scene/accel.py wide_tables): wide nodes, the mesh
  // rows' v0, e1, e2, and the walk's first entry (-1: nothing to walk)
  const float* __restrict__ wnodes;
  const float* __restrict__ mesh_vt;
  int top;
  // the kernels' own tables (scene/pack.py): the env-map cdfs' guide
  // tables, the immediates' cast rows
  const uint8_t* __restrict__ env_guide;
  const float* __restrict__ imm;
};

// the sort key of a child the ray does not enter: above any entry t a
// walk keeps (at most BIG)
#define WALK_MISS 3.4e38f

// What the walks of one cast did, kept only by the -DWALK_COUNT=1 build
// (`mega_path_mesh_count`, which `python -m rene_tpu_torch.probe --scene
// big_mesh` alone launches): per cast kind (closest, shadow) the casts,
// interior nodes visited and boxes tested, leaves visited and triangles
// tested, instances and table blocks entered, at each head of a walk
// loop the lanes of the warp active there (its leader adds
// __popc(__activemask()) and one warp step), the clock cycles of the
// walk, and the deepest stack. A cast flushes its counts, summed over
// the lanes of its warp that end it together, to walk_counts[kind *
// N_WALK_COUNTS + i]; the kernel adds its threads' cycles after them.
#define N_WALK_COUNTS 11
#if defined(WALK_COUNT) && WALK_COUNT
// the SM's clock (device code only)
__device__ __forceinline__ long long walk_clock() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}
__device__ unsigned long long walk_counts[2 * N_WALK_COUNTS + 1];
struct WalkCounts {
  uint32_t nodes = 0, boxes = 0, leaves = 0, tris = 0, insts = 0,
           blocks = 0, active = 0, steps = 0, deep = 0;
  long long t0 = 0;
  __device__ WalkCounts() { t0 = walk_clock(); }
  __device__ __forceinline__ void node(int k) {
    nodes += 1u;
    boxes += (uint32_t)k;
  }
  __device__ __forceinline__ void box(int k) { boxes += (uint32_t)k; }
  __device__ __forceinline__ void leaf(int k) {
    leaves += 1u;
    tris += (uint32_t)k;
  }
  __device__ __forceinline__ void inst() { insts += 1u; }
  __device__ __forceinline__ void block() { blocks += 1u; }
  __device__ __forceinline__ void stack(int sp) {
    deep = deep > (uint32_t)sp ? deep : (uint32_t)sp;
  }
  __device__ __forceinline__ void step() {
    const unsigned am = __activemask();
    if ((threadIdx.x & 31u) == (unsigned)(__ffs(am) - 1)) {
      active += (uint32_t)__popc(am);
      steps += 1u;
    }
  }
  __device__ __forceinline__ void flush(int kind) {
    const unsigned am = __activemask();
    const uint32_t v[N_WALK_COUNTS - 1] = {
        1u, nodes, boxes, leaves, tris, insts, blocks, active, steps,
        (uint32_t)(walk_clock() - t0)};
    uint32_t s[N_WALK_COUNTS - 1];
    for (int i = 0; i < N_WALK_COUNTS - 1; ++i)
      s[i] = __reduce_add_sync(am, v[i]);
    const uint32_t d = __reduce_max_sync(am, deep);
    if ((threadIdx.x & 31u) == (unsigned)(__ffs(am) - 1)) {
      unsigned long long* c = walk_counts + kind * N_WALK_COUNTS;
      for (int i = 0; i < N_WALK_COUNTS - 1; ++i)
        atomicAdd(c + i, (unsigned long long)s[i]);
      atomicMax(c + N_WALK_COUNTS - 1, (unsigned long long)d);
    }
  }
};

// a thread's cycles, added after the walk counts
__device__ __forceinline__ void walk_lane_cycles(long long t0) {
  atomicAdd(walk_counts + 2 * N_WALK_COUNTS,
            (unsigned long long)(walk_clock() - t0));
}

// The counting build's walk counts: copied to the 2 * N_WALK_COUNTS + 1
// uint64 words at `out` (device memory) on `stream`, then zeroed where
// `reset`; returns cudaGetLastError().
extern "C" int walk_counts_read(void* out, int reset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemcpyFromSymbolAsync(out, walk_counts, sizeof(walk_counts), 0,
                            cudaMemcpyDeviceToDevice, st);
  if (reset) {
    void* c = nullptr;
    cudaGetSymbolAddress(&c, walk_counts);
    cudaMemsetAsync(c, 0, sizeof(walk_counts), st);
  }
  return (int)cudaGetLastError();
}
#else
struct WalkCounts {
  __device__ __forceinline__ void node(int) {}
  __device__ __forceinline__ void box(int) {}
  __device__ __forceinline__ void leaf(int) {}
  __device__ __forceinline__ void inst() {}
  __device__ __forceinline__ void block() {}
  __device__ __forceinline__ void stack(int) {}
  __device__ __forceinline__ void step() {}
  __device__ __forceinline__ void flush(int) {}
};
#endif

// the closest hit of a walk so far: t (the running bound), the
// barycentrics of a triangle, its part and row (-1 where none)
struct WalkHit {
  float t, u, v;
  int part, row;
};

// whether a hit at (t, part, row) takes the place of h
__device__ __forceinline__ bool closer(float t, int part, int row,
                                       const WalkHit& h) {
  return t < h.t
      || (t == h.t && (part < h.part || (part == h.part && row < h.row)));
}

// 1 / d with |d| held above 1e-20, sign kept (_inv_dir :2057)
__device__ __forceinline__ float inv_guard(float x) {
  return 1.f / (fabsf(x) > 1e-20f ? x : (x >= 0.f ? 1e-20f : -1e-20f));
}

__device__ __forceinline__ V3 inv3(V3 d) {
  return v3(inv_guard(d.x), inv_guard(d.y), inv_guard(d.z));
}

// a walk entry or a packed word from its int32 bits in a table row
__device__ __forceinline__ int entry_of(float f) {
#ifdef __CUDACC__
  return __float_as_int(f);
#else
  int e;
  __builtin_memcpy(&e, &f, 4);
  return e;
#endif
}

// slab test of child box (lo, hi) in the plain walk's arithmetic (the
// box test of ops/bvh.py); its sort key: the entry distance where the ray
// enters it within [tmin, tfar], else WALK_MISS
__device__ __forceinline__ float child_key(int ref, float lx, float hx,
                                           float ly, float hy, float lz,
                                           float hz, V3 o, V3 inv,
                                           float tmin, float tfar) {
  const float t0x = (lx - o.x) * inv.x, t1x = (hx - o.x) * inv.x;
  const float t0y = (ly - o.y) * inv.y, t1y = (hy - o.y) * inv.y;
  const float t0z = (lz - o.z) * inv.z, t1z = (hz - o.z) * inv.z;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  return ref >= 0 && fmaxf(tn, tmin) <= fminf(tf, tfar) ? tn : WALK_MISS;
}

// one exchange of the sorting network: the nearer key first
__device__ __forceinline__ void order2(float& ka, int& ca, float& kb,
                                       int& cb) {
  const bool swap = kb < ka;
  const float k = swap ? kb : ka;
  const int c = swap ? cb : ca;
  kb = swap ? ka : kb;
  cb = swap ? ca : cb;
  ka = k;
  ca = c;
}

// Möller-Trumbore against mesh_vt row r; the caller applies its t bounds
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

// a stack entry: a walk entry and the t at which its box is entered
struct WalkEnt {
  int e;
  float tn;
};

// A thread's walk stack, in local memory (L1-cached and interleaved
// across threads, so a warp's pushes and pops at one depth coalesce).
struct WalkStack {
  WalkEnt mem[TRAVERSAL_STACK];
  int sp;
  __device__ __forceinline__ void init() { sp = 0; }
  __device__ __forceinline__ void push(int e, float tn) {
    if (sp < TRAVERSAL_STACK) {
      mem[sp].e = e;
      mem[sp].tn = tn;
      sp = sp + 1;
    }
  }
  __device__ __forceinline__ bool empty() const { return sp == 0; }
  __device__ __forceinline__ int size() const { return sp; }
  __device__ __forceinline__ WalkEnt pop() {
    sp = sp - 1;
    return mem[sp];
  }
};

// The walk of one cast from the scene's first entry, the ray (o, d) in
// world space. ANY: true at the first hit in [tmin, tmax]. Otherwise the
// closest hit with t >= tmin that is `closer` than h goes to h; where
// EITHER and `first`, the walk returns true at the first hit it takes: an
// any-hit walk in [tmin, tmax] where the caller set h.t to tmax and
// h.part and h.row above every part and row (the same hits, visited
// nearest first).
template <bool ANY, bool EITHER = false>
__device__ __forceinline__ bool walk(const Scene& s, const V3 o_w,
                                     const V3 d_w, float tmin, float tmax,
                                     WalkHit& h, WalkCounts& cnt,
                                     bool first = false) {
  V3 o = o_w, d = d_w, inv = inv3(d_w);
  int part = PART_WORLD;  // of the triangles under the walk now
  WalkStack st;
  st.init();
  int e = s.top;
  while (true) {
    cnt.step();
    const int tag = e >> TAG_SHIFT, pay = e & TAG_PAYLOAD;
    bool go = false;  // e is the next entry
    if (tag == TAG_NODE) {
      const float* n = s.wnodes + (size_t)pay * NODE4_W;
      const float4 lx = load4(n + NODE4_LX), hx = load4(n + NODE4_HX);
      const float4 ly = load4(n + NODE4_LY), hy = load4(n + NODE4_HY);
      const float4 lz = load4(n + NODE4_LZ), hz = load4(n + NODE4_HZ);
      const float4 rf = load4(n + NODE4_REF);
      int c0 = entry_of(rf.x), c1 = entry_of(rf.y), c2 = entry_of(rf.z),
          c3 = entry_of(rf.w);
      cnt.node((c0 >= 0) + (c1 >= 0) + (c2 >= 0) + (c3 >= 0));
      const float tfar = ANY ? tmax : h.t;
      float k0 = child_key(c0, lx.x, hx.x, ly.x, hy.x, lz.x, hz.x, o, inv,
                           tmin, tfar);
      float k1 = child_key(c1, lx.y, hx.y, ly.y, hy.y, lz.y, hz.y, o, inv,
                           tmin, tfar);
      float k2 = child_key(c2, lx.z, hx.z, ly.z, hy.z, lz.z, hz.z, o, inv,
                           tmin, tfar);
      float k3 = child_key(c3, lx.w, hx.w, ly.w, hy.w, lz.w, hz.w, o, inv,
                           tmin, tfar);
      if constexpr (!ANY) {
        // nearest first; any hit ends the walk, whatever its order
        order2(k0, c0, k1, c1);
        order2(k2, c2, k3, c3);
        order2(k0, c0, k2, c2);
        order2(k1, c1, k3, c3);
        order2(k1, c1, k2, c2);
      }
      if (k3 < WALK_MISS) st.push(c3, k3);
      if (k2 < WALK_MISS) st.push(c2, k2);
      if (k1 < WALK_MISS) st.push(c1, k1);
      cnt.stack(st.size());
      if (k0 < WALK_MISS) {
        e = c0;
        go = true;
      }
    } else if (tag == TAG_LEAF) {
      const int start = pay >> LEAF_COUNT_BITS;
      const int end = start + (pay & ((1 << LEAF_COUNT_BITS) - 1));
      cnt.leaf(end - start);
      for (int k = start; k < end; ++k) {
        float t, u, v;
        if (!mt_test(s.mesh_vt + (size_t)k * VT_W, o, d, t, u, v)) continue;
        if (ANY) {
          if (t >= tmin && t <= tmax) return true;
        } else if (t >= tmin && closer(t, part, k, h)) {
          h.t = t;
          h.u = u;
          h.v = v;
          h.part = part;
          h.row = k;
          if constexpr (EITHER)
            if (first) return true;
        }
      }
    } else if (tag == TAG_INST) {
      // into the instance's object space, back at its marker
      const float* m = s.insts + (size_t)pay * INST_W;
      cnt.inst();
      to_object(m, o_w, d_w, o, d);
      inv = inv3(d);
      part = PART_INST + pay;
      st.push(TAG_MARKER, 0.f);
      cnt.stack(st.size());
      e = (int)__ldg(m + INST_WROOT);  // a node: TAG_NODE is 0
      go = true;
    } else {
      // a block of the sphere table, in world space
      cnt.block();
      const int tpart = PART_INST + s.n_inst;
      for (int k = pay * SPH_BLOCK; k < (pay + 1) * SPH_BLOCK; ++k) {
        float t;
        if (!sph_test(load4(s.sph_tab + k * SPHT_W + SPHT_C), o, d, tmin, t))
          continue;
        if (ANY) {
          if (t <= tmax) return true;
        } else if (closer(t, tpart, k, h)) {
          h.t = t;
          h.part = tpart;
          h.row = k;
          if constexpr (EITHER)
            if (first) return true;
        }
      }
    }
    while (!go) {
      // the next entry still in reach, back in world space at a marker
      if (st.empty()) return false;
      const WalkEnt x = st.pop();
      if (x.e == TAG_MARKER) {
        o = o_w;
        d = d_w;
        inv = inv3(d_w);
        part = PART_WORLD;
      } else if (fmaxf(x.tn, tmin) <= (ANY ? tmax : h.t)) {
        e = x.e;
        go = true;
      }
    }
  }
}
