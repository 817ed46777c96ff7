// The C entry point of the megakernel, shared by csrc/mega_path.cu (its
// path and volpath builds) and the CPU builds of the per-lane code in
// tests/test_torch_kernel_source.py. The includer defines
//   static int run_lanes(const Params& p, void* stream);
// which runs trace_lane over the film's lanes.
// Argument order: see rene_tpu_torch/kernels.py ARGTYPES.
#pragma once
#include <stdint.h>

#include "mega_lane.cuh"

extern "C" int mega_path_launch(
    const float* tris, int n_tris, const float* sph, int n_sph,
    const float* mats, const float* eo, int n_eo, const int* emit_tris,
    int n_emit_tris, const int* emit_sph, int n_emit_sph, const float* lights,
    const float* light_dots, int n_lights, const float* cam,
    const float* mesh, const float* insts, int n_inst,
    const float* sph_tab, const float* wnodes, const float* mesh_vt, int top,
    const float* mesh_uv, int n_mesh_uv, const int* atlas,
    const float* env_mcdf, const float* env_ccdf, const float* env_pdf,
    const unsigned char* env_guide, const float* imm,
    int has_tri_emitter, int width, int n_pix, int max_depth,
    int use_rr, int beckmann, int has_accel, int block_seed, int has_tex,
    int has_env, int tex, int sobol, const float* media, int n_media, int seed,
    int num_samples, int pack, float* out, void* stream) {
  Params p;
  p.s = Scene{tris, sph, mats, eo, emit_tris, emit_sph, lights, light_dots,
              cam, n_tris, n_sph, n_eo, n_emit_tris, n_emit_sph, n_lights,
              has_tri_emitter, mesh, insts, sph_tab, n_inst, mesh_uv,
              (const uint32_t*)atlas, env_mcdf, env_ccdf, env_pdf, n_mesh_uv,
              has_tex, has_env, tex, wnodes, mesh_vt, top,
              env_guide, imm};
  p.width = width;
  p.n_pix = n_pix;
  p.max_depth = max_depth;
  p.use_rr = use_rr;
  p.beckmann = beckmann;
  p.num_samples = num_samples;
  p.has_accel = has_accel;
  p.block_seed = block_seed;
  p.block = 32;  // 32 / sqrt(pack)
  for (int q = pack; q > 1; q /= 4) p.block /= 2;
  p.n_lanes = n_pix * pack;
  p.sobol = sobol;
  p.seed = (uint32_t)seed;
  p.out = out;
  p.media = media;
  p.n_media = n_media;
  return run_lanes(p, stream);
}
