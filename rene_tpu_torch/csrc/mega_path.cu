// Path-tracing megakernel for NVIDIA Hopper (sm_90a), slice K1a.
//
// Replaces rene_tpu/integrators/pallas_path.py:_build_kernel.kernel (the
// TPU megakernel, :4266) with its path `body` (:4349) for scenes whose
// triangles fit the immediates budget: baked triangles and spheres, solid
// materials and background, distant lights, the independent sampler, one
// sample slot per lane (pack = 1). The plain PyTorch version is
// rene_tpu_torch/integrators/mega_path.py:path_lanes_ref.
//
// Design. One thread owns one pixel and streams `num_samples` paths back
// to back, regenerating a camera ray when a path ends: camera ray,
// closest hit, emitter hit, distant-light NEE with shadow rays, BSDF
// sampling, the 50/50 emitter/BSDF MIS, Russian roulette from depth 12.
// The TPU kernel baked every triangle, material and light into its
// program as immediates because Mosaic has no per-lane gather; a CUDA
// thread gathers, so the scene arrives as flat float32 tables in device
// memory (csrc/layout.cuh) and one build serves every scene. Each thread
// writes its own ten per-lane sums to a (10, N) array, the layout of the
// JAX kernel's ten output planes, so no atomics are needed.
//
// What bounds it. The tables are a few KB and stay in L1/L2; a bounce
// costs ~25 flops per triangle per ray in the brute-force loops plus
// divergent per-material control flow, so the kernel is bound by latency
// and compute, not by bytes. Later work: tables in shared or constant
// memory, a BVH for larger meshes, and path-state regrouping against
// divergence.
//
// Random numbers come from the per-lane xorshift32 stream of the JAX
// kernel's interpret mode (math.cuh). Each iteration draws, whether or
// not a branch uses them: u_coin, u1, u2, ul; coin, ue1..ue4 when the
// scene has emitters; rrv when Russian roulette is on; cj1, cj2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "path.cuh"

__global__ void __launch_bounds__(128) mega_path_kernel(const Params p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < p.n_pix) trace_lane(p, lane);
}

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError().
extern "C" int mega_path_launch(
    const float* tris, int n_tris, const float* sph, int n_sph,
    const float* mats, const float* eo, int n_eo, const int* emit_tris,
    int n_emit_tris, const int* emit_sph, int n_emit_sph, const float* lights,
    const float* light_dots, int n_lights, const float* cam,
    int has_tri_emitter, int width, int n_pix, int max_depth, int use_rr,
    int beckmann, int seed, int num_samples, float* out, void* stream) {
  Params p;
  p.s = Scene{tris, sph, mats, eo, emit_tris, emit_sph, lights, light_dots,
              cam, n_tris, n_sph, n_eo, n_emit_tris, n_emit_sph, n_lights,
              has_tri_emitter};
  p.width = width;
  p.n_pix = n_pix;
  p.max_depth = max_depth;
  p.use_rr = use_rr;
  p.beckmann = beckmann;
  p.num_samples = num_samples;
  p.seed = (uint32_t)seed;
  p.out = out;
  const int threads = 128;
  const int blocks = (n_pix + threads - 1) / threads;
  if (blocks > 0)
    mega_path_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
