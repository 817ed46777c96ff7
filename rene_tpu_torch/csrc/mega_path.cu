// Path-tracing megakernel for NVIDIA Hopper (sm_90a), slices K1a, K1b,
// K1c and K1d, and its volpath body, slice K1e.
//
// Replaces rene_tpu/integrators/pallas_path.py:_build_kernel.kernel (the
// TPU megakernel, :4266) with its path `body` (:4349): baked triangles
// and spheres, materials with solid, checker and imagemap slots, a
// constant, checker or env-map background with env-map light sampling
// (texture.cuh), distant lights (unrolled or from the light table), the
// independent sampler; and, past the immediates budget, the big-mesh march
// (`mesh_closest` :2255, `mesh_any` :2440) over the world mesh and
// shared-BLAS instances and the sphere table (`sphere_closest` :2636,
// `sphere_any` :2663), as one per-thread walk of 4-wide BVHs over the
// world mesh, the instances and the sphere table (bvh.cuh). The plain
// PyTorch version is rene_tpu_torch/integrators/mega_path.py:path_lanes_ref.
//
// Two variants, one template: mega_path_kernel<false> (K1a) reads the
// immediates only; mega_path_kernel<true> adds the acceleration tables,
// so the K1a variant keeps its registers and speed. Each build of this
// file holds one of them, picked by -DMEGA_MESH=0 or 1
// (rene_tpu_torch/kernels.py builds all variants at once).
//
// -DMEGA_VOL=1 builds the volpath megakernel instead (K1e, replacing
// `body_vol` :4572-4841 with `med_*` :3287-3361 and `tr_march`
// :3363-3430; plain version integrators/volpath.py): csrc/volpath.cuh's
// bounce, with each lane's medium, distance sampling, Henyey-Greenstein
// NEE and the transmittance march (csrc/medium.cuh), which walks up to 32
// closest hits through None surfaces. A separate build, not a runtime
// branch, so the path variants compile from the code they had. What
// bounds it: the casts, a march per light at every scatter point and
// surface, and divergence between the lanes of a warp: without Russian
// roulette they end their paths far apart, and a bounce casts from four
// places (the closest hit, the marches of a scatter point's lights and
// emitter, those of a surface's lights), each march a loop of walks.
// Its design for this card (mega_lane.cuh vol_lane over vol_loop.cuh
// vol_step, which K2's volpath lanes share): the lane loop is a
// state machine that casts once per step from one call site, the path
// ray or a march's next segment, so that the lanes of a warp that need a
// walk walk together and the march is no real call (no spills at a call
// boundary, one inlined copy of the walk); a lane whose bounce is due
// waits while a lane of its warp marches, so that the warp shades its
// bounces together (vol_loop.cuh step_now). On immediates with emitters
// and without distant lights (mega_lane.cuh vol_queues) a bounce marches
// only at a scatter point toward the emitters, so a march step carried a
// few lanes of 32; there the immediates build launches its QUEUE instance: a lane
// puts its marches in a queue in the block's shared memory
// (vol_queue.cuh) and goes on with its path, and warps of the block run
// queued marches 32 at a time (mega_lane.cuh vol_warp_step), the lane
// adding their sums in its own order. -DMEGA_COUNT=1 (with MEGA_VOL)
// builds the same loops with step counts (vol_loop.cuh StepCounts, read
// by its entry point step_counts) for the probe and the benchmark's
// traced runs, on no render path.
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
// Sample-in-tile packing (K1f; pallas_path.py:4307-4337, :5897-5938,
// :5976-5980): on a cluster-mode scene a launch may run `pack` (1, 4, 16,
// 64 or 256) sample slots per pixel, one thread each. Thread l traces
// pixel l % n_pix at slot l / n_pix, its stream seeded per (32 /
// sqrt(pack))-pixel block and by its lane id, its Sobol key mixed with the
// slot (mega_lane.cuh lane_start), and writes its sums at row stride n_pix
// * pack (size_t offsets); the caller sums the slots. A parameter, not a
// build: pack 1 computes what it computed before. What it buys here: the
// mesh builds keep 67,584 threads resident (four 128-thread blocks on each
// of 132 SMs), so a smaller film leaves SMs idle at any spp; packing
// multiplies its threads at the same delivered spp. The TPU's reason, a
// tighter beam for its any-lane cluster cull, has no counterpart in a
// per-thread BVH walk.
//
// What bounds it. The immediates' cast rows are a few KB in each block's
// shared memory (intersect.cuh stage_imm); a bounce costs ~25 flops per
// immediate triangle per ray plus divergent per-material control flow:
// in the Cornell box's 64-spp launch the closest-hit casts hold 61% of
// the threads' clock cycles (the counting build -DPATH_COUNT=1,
// `mega_path_count`, PERF.md section 6). The mesh variant adds a tree
// walk per ray cast: dependent node loads (latency) and divergence
// between the threads of a warp, not bytes; in the big mesh's 16-spp
// launch the walks hold 48% of the threads' clock cycles with the binary
// walk and 49.7% with the 4-wide one (the counting build -DWALK_COUNT=1,
// PERF.md section 6). Later work: path-state regrouping against
// divergence.
//
// `Sampler "sobol"` (K-sobol): every build holds a second instance of its
// kernel, template parameter SOBOL, launched where the parameters ask for
// it: the bounce's and the camera's draws are Sobol pairs (csrc/sobol.cuh;
// `ld2` and `sob_pixkey`, pallas_path.py:1697-1720, draws at :4328-4341,
// :4437-4542, :4704-4812), and a volpath bounce keeps its medium, phase
// and scatter-point emitter draws on the stream. A separate instance, not
// a runtime branch, so the independent instances keep the code they had.
// A Sobol pair costs ~100 integer operations and no memory access.
//
// Random numbers come from the per-lane xorshift32 stream of the JAX
// kernel's interpret mode (math.cuh). Each iteration draws, whether or
// not a branch uses them: u_coin, u1, u2, ul; coin, ue1..ue4 when the
// scene has emitters or an env-map strategy, then upick when it has both;
// rrv when Russian roulette is on; cj1, cj2. Which of these a scene draws
// comes from flags in the parameter struct, the same for every thread of
// a launch, as do the texture and background branches. Every build holds
// each kernel twice more, template parameter TEX: a scene that runs no
// texture code (Scene::tex 0: no textured material or background, no
// env-map sampling) launches the instance that holds none.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mega_lane.cuh"

#ifndef MEGA_MESH
#define MEGA_MESH 0
#endif
#ifndef MEGA_VOL
#define MEGA_VOL 0
#endif
// Blocks of 128 threads that must fit an SM (ptxas caps the registers to
// fit them): nine for the immediates variant (56 registers, 368-496 bytes
// of spill stores across its four instances) and twelve for the mesh
// variant (40 registers, 960-1300 bytes). More resident warps hide the
// loads and divergence of a lane loop better than registers do: swept in
// turns on an NVIDIA H100 80GB HBM3 at 700.00 W (`python -m
// rene_tpu_torch.probe --compare`, PERF.md section 6), the Cornell box's
// 64-spp launch at 4 / 5 / 6 / 7 / 8 / 9 / 10 blocks
// 31.195 / 28.351 / 27.204 / 26.523 / 25.934 / 25.313 / 27.076 ms (each
// step against its neighbour in one run), the big mesh's 16-spp launch
// at 4 / 5 / 7 / 8 / 10 / 12 / 16 52.629 / 52.221 / 51.751 / 51.293 /
// 50.346 / 48.769 / 49.539 and the textured mesh's at 10 / 12 / 16
// 39.531 / 37.721 / 37.899
#define PATH_MIN_BLOCKS (MEGA_MESH ? 12 : 9)
// the volpath variants' floor: ten blocks for the mesh variant (48
// registers, 1124-1760 bytes of spill stores) and sixteen, the most an SM
// holds, for the immediates one (32, 1532-2364), swept as above: the fog
// mesh's 16-spp launch at 4 / 5 / 6 / 7 / 10 / 12 / 16
// blocks 248.701 / 249.568 / 248.485 / 237.085 / 235.810 / 235.715 /
// 283.031 ms, the fog scene's at 6 / 7 / 8 / 9 / 12 / 16 108.848 /
// 103.063 / 99.375 / 95.108 / 92.959 / 91.310
#define VOL_MIN_BLOCKS (MEGA_MESH ? 10 : 16)
// the immediates volpath instance that marches through the block's queue
// (vol_queue.cuh, 11,424 bytes of shared memory a block beside the cast
// rows): six blocks (80 registers, 400-528 bytes of spill stores), where
// the inline loop wanted every block an SM holds; its bookkeeping lives
// across the cast, and fewer, fatter threads spill less. Swept in turns
// on the Cornell smoke scene's 100-spp launch at 600x600 (NVIDIA H100
// 80GB HBM3, 700.00 W, CUDA events, medians; PERF.md section 6) at two
// queue slots a lane: 4 / 6 / 8 / 10 / 12 / 16 blocks 50.64 / 45.77 /
// 49.14 / 61.47 / 60.98 / 78.11 ms (the inline loop at 16: 88.06)
#define VOL_QUEUE_MIN_BLOCKS 6

// TEX: the instance for scenes that run texture code (Scene::tex); the
// other holds none (path.cuh without_tex)
#if MEGA_VOL
// QUEUE: the instance that marches through the block's queue (every
// thread of the block runs the queued loop, mega_lane.cuh vol_warp_step),
// for the scenes of vol_queues; the other marches inline (vol_lane)
template <bool MESH, bool SOBOL, bool TEX, bool QUEUE>
__global__ void __launch_bounds__(128, QUEUE ? VOL_QUEUE_MIN_BLOCKS
                                             : VOL_MIN_BLOCKS)
mega_volpath_kernel(const __grid_constant__ Params p) {
  if constexpr (QUEUE) {
    MarchQueue& q = march_queue(p.s);
    queue_init(q, threadIdx.x);
    stage_imm(p.s);  // its barrier ends the queue's start too
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if constexpr (TEX)
      vol_queue_lane<MESH, SOBOL>(p, i, q);
    else
      vol_queue_lane<MESH, SOBOL>(without_tex(p), i, q);
  } else {
    stage_imm(p.s);
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < p.n_lanes) {
      if constexpr (TEX)
        trace_lane<MESH, true, SOBOL>(p, lane_of(p, i));
      else
        trace_lane<MESH, true, SOBOL>(without_tex(p), lane_of(p, i));
    }
  }
}
#else
template <bool MESH, bool SOBOL, bool TEX>
__global__ void __launch_bounds__(128, PATH_MIN_BLOCKS)
mega_path_kernel(const Params p) {
  stage_imm(p.s);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
#if defined(WALK_COUNT) && WALK_COUNT
  const long long t0 = walk_clock();
#elif defined(TEX_COUNT) && TEX_COUNT
  const long long t0 = tex_clock();
#elif defined(PATH_COUNT) && PATH_COUNT
  path_begin();
  const long long t0 = path_clock();
#endif
  if (i < p.n_lanes) {
    if constexpr (TEX)
      trace_lane<MESH, false, SOBOL>(p, lane_of(p, i));
    else
      trace_lane<MESH, false, SOBOL>(without_tex(p), lane_of(p, i));
  }
#if defined(WALK_COUNT) && WALK_COUNT
  walk_lane_cycles(t0);
#elif defined(TEX_COUNT) && TEX_COUNT
  tex_lane_cycles(t0);
#elif defined(PATH_COUNT) && PATH_COUNT
  path_flush(t0, i < p.n_lanes);
#endif
}
#endif

// this build's kernel instance (SOBOL, TEX) over `blocks` blocks; in a
// volpath build, the one that marches through the block's queue where
// the scene's tables ask for it (mega_lane.cuh vol_queues)
template <bool SOBOL, bool TEX>
static void launch_lanes(const Params& p, int blocks, cudaStream_t st) {
#if MEGA_VOL && !MEGA_MESH
  if (vol_queues<false>(p.s))
    launch_staged_with(sizeof(MarchQueue),
                       mega_volpath_kernel<false, SOBOL, TEX, true>, p.s,
                       blocks, st, p);
  else
    launch_staged(mega_volpath_kernel<false, SOBOL, TEX, false>, p.s, blocks,
                  st, p);
#elif MEGA_VOL
  launch_staged(mega_volpath_kernel<true, SOBOL, TEX, false>, p.s, blocks,
                st, p);
#else
  launch_staged(mega_path_kernel<MEGA_MESH != 0, SOBOL, TEX>, p.s, blocks, st,
                p);
#endif
}

// Launch this build's variant on `stream` (a cudaStream_t), the instance
// of the scene's sampler and of its texture code; returns
// cudaGetLastError(), or cudaErrorInvalidValue for scene tables of the
// other variant. The counting build (-DMEGA_COUNT=1) holds the
// independent instances alone and refuses Sobol tables.
static int run_lanes(const Params& p, void* stream) {
  if ((p.has_accel != 0) != (MEGA_MESH != 0))
    return (int)cudaErrorInvalidValue;
#if defined(MEGA_COUNT) && MEGA_COUNT
  if (p.sobol) return (int)cudaErrorInvalidValue;
#endif
  const int threads = 128;
  const int blocks = (p.n_lanes + threads - 1) / threads;
  if (blocks > 0) {
    cudaStream_t st = (cudaStream_t)stream;
#if !(defined(MEGA_COUNT) && MEGA_COUNT)
    if (p.sobol && p.s.tex)
      launch_lanes<true, true>(p, blocks, st);
    else if (p.sobol)
      launch_lanes<true, false>(p, blocks, st);
    else
#endif
    if (p.s.tex)
      launch_lanes<false, true>(p, blocks, st);
    else
      launch_lanes<false, false>(p, blocks, st);
  }
  return (int)cudaGetLastError();
}

#include "launch.cuh"

// the ray-cast and texture-fetch probes, in the mesh builds and the path
// immediates build
#if MEGA_MESH || !MEGA_VOL
#include "cast_launch.cuh"
#include "tex_launch.cuh"

// the ray-cast probe (cast_launch.cuh): one thread per ray
__global__ void __launch_bounds__(128)
    cast_probe_kernel(const Scene s, const float* __restrict__ rays, int n,
                      float* __restrict__ out) {
  stage_imm(s);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    cast_ray<MEGA_MESH != 0>(s, rays + (size_t)i * RAY_W,
                             out + (size_t)i * CAST_OUT_W);
}

static int run_casts(const Scene& s, const float* rays, int n, float* out,
                     void* stream) {
  const int blocks = (n + 127) / 128;
  if (blocks > 0)
    launch_staged(cast_probe_kernel, s, blocks, (cudaStream_t)stream, s, rays,
                  n, out);
  return (int)cudaGetLastError();
}

// the texture-fetch probe (tex_launch.cuh): one thread per fetch
__global__ void __launch_bounds__(128)
    tex_probe_kernel(const uint32_t* __restrict__ atlas,
                     const float* __restrict__ rows, int n,
                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    fetch_row(atlas, rows + (size_t)i * TEXP_W, out + (size_t)i * TEXP_OUT_W);
}

static int run_fetches(const uint32_t* atlas, const float* rows, int n,
                       float* out, void* stream) {
  const int blocks = (n + 127) / 128;
  if (blocks > 0)
    tex_probe_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(atlas, rows,
                                                               n, out);
  return (int)cudaGetLastError();
}
#endif
