// The C entry points of the wave kernels, shared by csrc/wave.cu and the
// CPU build of the per-lane code in tests/test_torch_wave.py. The
// includer defines
//   static int run_wave(const WaveParams& p, void* stream);
//   static int run_genesis(const GenesisParams& g, void* stream);
//   static int run_permute(const float* in, const int* perm, int n_pad,
//                          float* out, void* stream);
//   static int run_probe(const int* in, int n, int* out, void* stream);
// Argument order: see rene_tpu_torch/kernels.py WAVE_ARGTYPES,
// GENESIS_ARGTYPES, PERMUTE_ARGTYPES and PROBE_ARGTYPES.
#pragma once
#include <stdint.h>

#include "wave.cuh"

extern "C" int wave_path_launch(
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
    int launch, int k, int n_run, int n_pad, int base, int rem, float lo_x,
    float lo_y, float lo_z, float scale_x, float scale_y, float scale_z,
    float* state, void* stream) {
  (void)block_seed;
  WaveParams p;
  p.s = Scene{tris, sph, mats, eo, emit_tris, emit_sph, lights, light_dots,
              cam, n_tris, n_sph, n_eo, n_emit_tris, n_emit_sph, n_lights,
              has_tri_emitter, mesh, insts, sph_tab, n_inst, mesh_uv,
              (const uint32_t*)atlas, env_mcdf, env_ccdf, env_pdf, n_mesh_uv,
              has_tex, has_env, tex, wnodes, mesh_vt, top,
              env_guide, imm};
  p.width = width;
  p.npix = n_pix;
  p.max_depth = max_depth;
  p.use_rr = use_rr;
  p.beckmann = beckmann;
  p.has_accel = has_accel;
  p.sobol = sobol;
  p.base = base;
  p.rem = rem;
  p.seed = (uint32_t)seed;
  p.launch = launch;
  p.k = k;
  p.n_run = n_run;
  p.n_pad = n_pad;
  p.klo[0] = lo_x;
  p.klo[1] = lo_y;
  p.klo[2] = lo_z;
  p.kscale[0] = scale_x;
  p.kscale[1] = scale_y;
  p.kscale[2] = scale_z;
  p.state = state;
  p.media = media;
  p.n_media = n_media;
  return run_wave(p, stream);
}

extern "C" int wave_genesis_launch(const float* cam, const float* px,
                                   const float* py, int width, int npix,
                                   int n_real, int n_pad, int seed, int base,
                                   int rem, int sobol, float* state,
                                   void* stream) {
  GenesisParams g;
  g.cam = cam;
  g.px = px;
  g.py = py;
  g.width = width;
  g.npix = npix;
  g.n_real = n_real;
  g.n_pad = n_pad;
  g.seed = (uint32_t)seed;
  g.base = base;
  g.rem = rem;
  g.sobol = sobol;
  g.state = state;
  return run_genesis(g, stream);
}

extern "C" int wave_permute_launch(const float* in, const int* perm,
                                   int n_pad, float* out, void* stream) {
  return run_permute(in, perm, n_pad, out, stream);
}

extern "C" int sobol_probe_launch(const int* in, int n, int* out,
                                  void* stream) {
  return run_probe(in, n, out, stream);
}
