// The ray-cast probe of the mesh builds and of the path immediates build:
// given rays cast one by one through trace_closest or shadow_any (the
// walk that every mesh build runs, or the immediates cast; MESH defaults
// to the mesh form), alone (no shading, no draws). It lies on no render
// path: `python -m rene_tpu_torch.probe --scene big_mesh` times it on
// rays that the plain version recorded, chip_smoke.py holds it to the
// plain walk, and tests/test_torch_walk.py compiles it with g++. The
// includer defines
//   static int run_casts(const Scene& s, const float* rays, int n,
//                        float* out, void* stream);
// which runs cast_ray over the n rays.
// Argument order: see rene_tpu_torch/kernels.py CAST_ARGTYPES.
#pragma once
#include <stdint.h>

#include "intersect.cuh"

// a probe ray's row: origin, direction, tmin, tmax, its kind (CAST_CLOSEST
// or CAST_SHADOW) and, for a shadow ray, its distant light
#define RAY_W 10
#define CAST_CLOSEST 0
#define CAST_SHADOW 1
// a probe ray's result: t (BIG on a miss; 0 for a shadow ray), the part
// and row of the closest hit (-1 on a miss or for a shadow ray), the
// hit flag (closest: t < BIG; shadow: the any-hit answer)
#define CAST_OUT_W 4

static int run_casts(const Scene& s, const float* rays, int n, float* out,
                     void* stream);

template <bool MESH = true>
__device__ __forceinline__ void cast_ray(const Scene& s,
                                         const float* __restrict__ ray,
                                         float* __restrict__ out) {
  const V3 o = v3(ray[0], ray[1], ray[2]);
  const V3 d = v3(ray[3], ray[4], ray[5]);
  if ((int)ray[8] == CAST_SHADOW) {
    const bool hit = shadow_any<MESH>(s, (int)ray[9], o, d, ray[6], ray[7]);
    out[0] = 0.f;
    out[1] = out[2] = -1.f;
    out[3] = hit ? 1.f : 0.f;
    return;
  }
  const Hit h = trace_closest<MESH>(s, o, d, ray[6]);
  out[0] = h.t;
  out[1] = (float)h.part;
  out[2] = (float)h.row;
  out[3] = h.t < BIG ? 1.f : 0.f;
}

extern "C" int cast_probe_launch(
    const float* tris, int n_tris, const float* sph, int n_sph,
    const float* mats, const float* eo, int n_eo, const int* emit_tris,
    int n_emit_tris, const int* emit_sph, int n_emit_sph, const float* lights,
    const float* light_dots, int n_lights, const float* cam,
    const float* mesh, const float* insts, int n_inst,
    const float* sph_tab, const float* wnodes, const float* mesh_vt, int top,
    const float* mesh_uv, int n_mesh_uv, const int* atlas,
    const float* env_mcdf, const float* env_ccdf, const float* env_pdf,
    const unsigned char* env_guide, const float* imm,
    int has_tri_emitter, int has_tex, int has_env,
    const float* rays, int n, float* out, void* stream) {
  const Scene s{tris, sph, mats, eo, emit_tris, emit_sph, lights, light_dots,
                cam, n_tris, n_sph, n_eo, n_emit_tris, n_emit_sph, n_lights,
                has_tri_emitter, mesh, insts, sph_tab, n_inst, mesh_uv,
                (const uint32_t*)atlas, env_mcdf, env_ccdf, env_pdf,
                n_mesh_uv, has_tex, has_env, 1, wnodes, mesh_vt, top,
              env_guide, imm};
  return run_casts(s, rays, n, out, stream);
}
