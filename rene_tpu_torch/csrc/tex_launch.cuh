// The texture-fetch probe of the path builds: recorded bilinear fetches
// (an image and a uv each) through fetch_image alone, one thread per
// fetch. It lies on no render path: `python -m rene_tpu_torch.probe
// --scene textured_mesh` times it on the fetches that the plain version
// recorded (ops/texture.py fetch_log), and chip_smoke.py holds it to the
// plain fetch bit for bit. The includer defines
//   static int run_fetches(const uint32_t* atlas, const float* rows,
//                          int n, float* out, void* stream);
// which runs fetch_row over the n rows.
// Argument order: see rene_tpu_torch/kernels.py TEX_PROBE_ARGTYPES.
#pragma once
#include <stdint.h>

#include "texture.cuh"

// a probe row: the image's texel offset, its width and height, then u
// and v; a result: rgb
#define TEXP_W 5
#define TEXP_OUT_W 3

static int run_fetches(const uint32_t* atlas, const float* rows, int n,
                       float* out, void* stream);

__device__ __forceinline__ void fetch_row(const uint32_t* __restrict__ atlas,
                                          const float* __restrict__ r,
                                          float* __restrict__ out) {
  fetch_image(atlas, __ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3),
              __ldg(r + 4), out);
}

extern "C" int tex_probe_launch(const int* atlas, const float* rows, int n,
                                float* out, void* stream) {
  return run_fetches((const uint32_t*)atlas, rows, n, out, stream);
}
