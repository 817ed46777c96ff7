// The wavefront engine's kernels for NVIDIA Hopper (sm_90a): K2, K3, K4.
//
// Replaces, in rene_tpu/integrators/pallas_path.py and pallas_wave.py:
//   wave_path_kernel     K2, `wave_kernel` (pallas_path.py:5567) with
//                        `wave_bounce` (:5052), launched by `call_kernel`
//                        (pallas_wave.py:271)
//   wave_genesis_kernel  K3, `genesis_kernel` (pallas_path.py:4970),
//                        launched by `_genesis_call` (pallas_wave.py:630)
//   wave_permute_kernel  K4, `_dma_perm_kernel` (pallas_wave.py:370),
//                        launched by `_dma_permute` (:386)
// The plain PyTorch versions are in rene_tpu_torch/integrators/wave.py.
//
// The state of a wave is one (W_NROWS, n_pad) float32 array (layout.cuh
// WROW_*); row r of lane l lies at r * n_pad + l, so the threads of a
// warp, one lane each, read and write each row as one coalesced 128-byte
// line.
//
// K2: one thread per lane of [0, n_run) advances its lane by k bounces in
// place: the megakernel's path body (path.cuh, so K1 keeps its registers)
// with its textures, textured background and env-map light sampling
// (texture.cuh), plus regeneration, parking and the next-launch key
// (wave.cuh). A parked
// lane returns after one load. Two variants from one template, like the
// megakernel: wave_path_kernel<false> reads the immediates only,
// wave_path_kernel<true> adds the mesh BVHs, instances and sphere table;
// each build of this file holds one, picked by -DMEGA_MESH=0 or 1. What
// bounds it: the ray casts (operations, dependent loads and divergence
// down the BVH), as in the megakernel; the state rows it moves, ~200
// bytes per alive lane, are a small share. The TPU kernel ran whole
// 1024-lane tiles in lock-step and skipped tiles past the alive prefix;
// a CUDA thread skips its own lane. Its design for this card (wave.cuh
// wave_lane): in the mesh variant a lane runs path_loop.cuh's state
// machine for its k bounces, one ray cast per step from one call site,
// the path ray or the next queued shadow ray (shadows first, by a warp
// vote), so that a warp's lanes walk together whichever ray each needs
// and the build holds one walk; a light whose contribution is zero casts
// no shadow ray. The immediates variant keeps one bounce after another,
// a closest cast and a shadow cast per light: on the Cornell box (no
// distant light) the state machine ran its wave 5-7% slower.
// -DMEGA_COUNT=1 (with MEGA_MESH, without MEGA_VOL) builds it with the
// loop's counts (path_loop.cuh PathCounts) for `python -m
// rene_tpu_torch.probe`.
//
// -DMEGA_VOL=1 builds K2 with the volpath bounce instead (`wave_bounce_vol`
// :5277-5565; csrc/volpath.cuh, csrc/medium.cuh), the variants
// wave_volpath and wave_volpath_mesh, which also read and write the
// lane's medium row WROW_MED. Its design for this card (wave.cuh
// wave_vol_lane): a lane runs the megakernel's lane loop (vol_loop.cuh
// vol_step: one ray cast per step from one call site, the path ray or a
// transmittance march's next segment, march first) for its k bounces,
// so that a warp's lanes walk together whatever their bounce's marches,
// one thread per lane. A grid of only the resident blocks, whose threads
// take lanes from a counter as they finish theirs, ran the fog mesh's
// wave 1.23x and the fog scene's 1.35x slower (PERF.md section 6): lanes
// taken one by one scatter the sorted neighbours of a warp.
// -DMEGA_COUNT=1 (with MEGA_VOL and MEGA_MESH) builds it with step counts
// (vol_loop.cuh StepCounts) for `python -m rene_tpu_torch.probe`.
//
// K3: one thread per lane writes all W_NROWS rows of a fresh wave from
// its pixel coordinates: 8 bytes read and 128 written per lane, bound by
// bytes. K4: one warp per 128-lane slice copies rows [0, W_SORT_PAD) from
// slice perm[j], which it reads once, and the AOV rows in place, each
// 512-byte slice-row as 32 16-byte words, PERM_ROWS rows of loads in
// flight per thread, PERM_WARPS slices a block: bound by bytes. The TPU
// version queued one DMA per slice.
//
// `Sampler "sobol"` (K-sobol): K2 and K3 each have a second instance,
// template parameter SOBOL, in every build, launched where the
// parameters ask for it: its draws are Sobol pairs (csrc/sobol.cuh), so
// the independent instances keep the code they had. A Sobol pair costs
// ~100 integer operations and no memory access beside a bounce's casts.
// sobol_probe_kernel is the counterpart of the Mosaic probe of the
// sampler's integer operations (scripts/tpu_session_r3ac.py:53, kernels
// k_xorshift :70, k_addmul :81, k_rev :91, k_lk :106, k_sobol16 :117),
// one thread per int32 input writing seven words: bound by bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wave.cuh"

#ifndef MEGA_MESH
#define MEGA_MESH 0
#endif
#ifndef MEGA_VOL
#define MEGA_VOL 0
#endif
// blocks of 128 threads that must fit an SM: six for the immediates
// variant (at most 80 registers, 196-240 bytes of spill stores across its
// four instances), five for the mesh variant (96 registers, 212-220
// bytes). Swept in turns on an NVIDIA H100 80GB HBM3 at 700.00 W (`python
// -m rene_tpu_torch.probe --compare`, PERF.md section 6): the Cornell
// wave's first K2 launch 2.544 / 2.279 / 2.247 ms at four / five / six
// blocks and 2.252 / 2.347 at six / seven (the bounce it keeps). The mesh
// variant's state machine, K2 summed over the deep mesh's / the textured
// deep mesh's / the big mesh's Sobol 16-spp wave at 4 / 5 / 6 / 8 / 10 /
// 12 blocks: 20.754 / 20.780 / 21.063 / 21.318 / 22.809 / 24.770 ms;
// 18.256 / 17.998 / 18.545 / 18.290 / 19.323 / 20.175; 21.121 / 20.507 /
// 20.581 / 20.905 / 22.421 / 24.031; its first launch on the big mesh
// 5.677 / 5.691 / 5.848 / 6.264 / 7.398 / 8.860 (121 registers and no
// spills at four, 96 and 184-228 bytes at five, 40 and 1296-1448 at 12)
#define PATH_MIN_BLOCKS (MEGA_MESH ? 5 : 6)

#if MEGA_VOL
// the volpath builds' floor, seven blocks for both variants: the mesh one
// at most 72 registers and 676-740 bytes of spill stores, the immediates
// one 72 and 392-528. Swept as above, K2 summed over the 16-spp waves:
// the fog mesh at 6 / 7 / 8 blocks 112.520 / 109.289 / 109.502 ms; the
// fog scene at 4 / 5 / 6 47.184 / 43.980 / 43.179, at 6 / 7 43.410 /
// 42.579, at 7 / 8 42.467 / 42.908, Sobol 45.176 / 45.950
#define WAVE_VOL_MIN_BLOCKS (MEGA_MESH ? 7 : 7)

// the parameters stay in the constant bank: the lane loop takes the
// scene by reference
// TEX: the instance for scenes that run texture code (Scene::tex); the
// other holds none (path.cuh without_tex)
template <bool MESH, bool SOBOL, bool TEX>
__global__ void __launch_bounds__(128, WAVE_VOL_MIN_BLOCKS)
wave_volpath_kernel(const __grid_constant__ WaveParams p) {
  stage_imm(p.s);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < p.n_run) {
    if constexpr (TEX)
      wave_vol_lane<MESH, SOBOL>(p, lane);
    else
      wave_vol_lane<MESH, SOBOL>(without_tex(p), lane);
  }
}
#else
template <bool MESH, bool SOBOL, bool TEX>
__global__ void __launch_bounds__(128, PATH_MIN_BLOCKS)
wave_path_kernel(const WaveParams p) {
  stage_imm(p.s);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < p.n_run) {
    if constexpr (TEX)
      wave_lane<MESH, SOBOL>(p, lane);
    else
      wave_lane<MESH, SOBOL>(without_tex(p), lane);
  }
}
#endif

template <bool SOBOL>
__global__ void __launch_bounds__(128)
    wave_genesis_kernel(const GenesisParams g) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < g.n_pad) genesis_lane<SOBOL>(g, lane);
}

__global__ void __launch_bounds__(128)
    sobol_probe_kernel(const int* __restrict__ in, int n,
                       int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) probe_lane(in, n, i, out);
}

// K4's warps per block: one block per slice, each warp W_NROWS /
// PERM_WARPS of its rows
#define PERM_WARPS 4

__global__ void __launch_bounds__(32 * PERM_WARPS)
    wave_permute_kernel(const float* __restrict__ in,
                        const int* __restrict__ perm, int n_pad,
                        float* __restrict__ out) {
  const int r0 = (int)(threadIdx.x >> 5) * (W_NROWS / PERM_WARPS);
  permute_slice(in, __ldg(perm + blockIdx.x), (size_t)n_pad, blockIdx.x,
                (int)(threadIdx.x & 31u), r0, r0 + W_NROWS / PERM_WARPS,
                out);
}

// this build's K2 instance (SOBOL, TEX) over `blocks` blocks
template <bool SOBOL, bool TEX>
static void launch_wave(const WaveParams& p, int blocks, cudaStream_t st) {
#if MEGA_VOL
  launch_staged(wave_volpath_kernel<MEGA_MESH != 0, SOBOL, TEX>, p.s, blocks,
                st, p);
#else
  launch_staged(wave_path_kernel<MEGA_MESH != 0, SOBOL, TEX>, p.s, blocks, st,
                p);
#endif
}

// Launch this build's variant, the instance of the scene's sampler and of
// its texture code; cudaErrorInvalidValue for scene tables of the other
// variant.
static int run_wave(const WaveParams& p, void* stream) {
  if ((p.has_accel != 0) != (MEGA_MESH != 0))
    return (int)cudaErrorInvalidValue;
  const int blocks = (p.n_run + 127) / 128;
  if (blocks > 0 && p.k > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (p.sobol && p.s.tex)
      launch_wave<true, true>(p, blocks, st);
    else if (p.sobol)
      launch_wave<true, false>(p, blocks, st);
    else if (p.s.tex)
      launch_wave<false, true>(p, blocks, st);
    else
      launch_wave<false, false>(p, blocks, st);
  }
  return (int)cudaGetLastError();
}

static int run_genesis(const GenesisParams& g, void* stream) {
  const int blocks = (g.n_pad + 127) / 128;
  if (blocks > 0) {
    if (g.sobol)
      wave_genesis_kernel<true>
          <<<blocks, 128, 0, (cudaStream_t)stream>>>(g);
    else
      wave_genesis_kernel<false>
          <<<blocks, 128, 0, (cudaStream_t)stream>>>(g);
  }
  return (int)cudaGetLastError();
}

static int run_probe(const int* in, int n, int* out, void* stream) {
  const int blocks = (n + 127) / 128;
  if (blocks > 0)
    sobol_probe_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(in, n, out);
  return (int)cudaGetLastError();
}

static int run_permute(const float* in, const int* perm, int n_pad,
                       float* out, void* stream) {
  if (n_pad % W_SLICE) return (int)cudaErrorInvalidValue;
  const int blocks = n_pad / W_SLICE;
  if (blocks > 0)
    wave_permute_kernel<<<blocks, 32 * PERM_WARPS, 0,
                          (cudaStream_t)stream>>>(in, perm, n_pad, out);
  return (int)cudaGetLastError();
}

#include "wave_launch.cuh"

#if MEGA_MESH
#include "cast_launch.cuh"

// the ray-cast probe (cast_launch.cuh): one thread per ray
__global__ void __launch_bounds__(128)
    cast_probe_kernel(const Scene s, const float* __restrict__ rays, int n,
                      float* __restrict__ out) {
  stage_imm(s);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    cast_ray(s, rays + (size_t)i * RAY_W, out + (size_t)i * CAST_OUT_W);
}

static int run_casts(const Scene& s, const float* rays, int n, float* out,
                     void* stream) {
  const int blocks = (n + 127) / 128;
  if (blocks > 0)
    launch_staged(cast_probe_kernel, s, blocks, (cudaStream_t)stream, s, rays,
                  n, out);
  return (int)cudaGetLastError();
}
#endif
