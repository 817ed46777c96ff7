// The volpath lane loop's step (K1e), shared by the megakernel's lane
// loop (mega_lane.cuh vol_lane) and K2's volpath lanes (wave.cuh
// wave_vol_lane). A lane is a small state machine with one ray cast per
// step, from one call site: the step casts the path ray (a bounce) or the
// current segment of a transmittance march, and then either shades the
// hit (volpath.cuh vol_shade, which queues the bounce's NEE marches) or
// advances the march (medium.cuh march_seg), taking its sum when it ends
// (nee_add) and starting the next queued one. When a bounce's last march
// has ended, or it queued none, the caller applies the bounce's verdict:
// the megakernel its depth cut and a new camera path, K2 the depth cut,
// the next-launch key, regeneration or parking. So the lanes of a warp
// that need a walk, for whatever reason, walk together; a lane whose
// bounce is due waits for the warp's marches (step_now), so that the warp
// shades together. The draws, casts and sums are a bounce's, in its
// order: a cast draws nothing, so drawing at shade time, after the cast,
// keeps the stream's sequence. Plain C++ apart from the CUDA qualifiers
// and intrinsics, so tests/test_torch_kernel_source.py compiles it with
// g++ too.
#pragma once
#include <stdint.h>

#include "volpath.cuh"

// Counts of the volpath lane loop's steps, kept only by the -DMEGA_COUNT=1
// builds (`mega_volpath_mesh_count`, `mega_volpath_count`,
// `wave_volpath_mesh_count`, on no render path): at the cast site, each
// warp's leader lane adds the lanes active there, __popc(__activemask()),
// and one warp step; each thread counts its steps, those that were march
// segments, and the lanes it ran. The sums go to vol_counts at the
// thread's end: active lanes, warp steps, lane steps, march steps, lanes.
#define N_VOL_COUNTS 5
#if defined(MEGA_COUNT) && MEGA_COUNT
__device__ unsigned long long vol_counts[N_VOL_COUNTS];
struct StepCounts {
  uint32_t active = 0, warp_steps = 0, steps = 0, march = 0, lanes = 0;
  __device__ __forceinline__ void step(bool marching) {
    const unsigned am = __activemask();
    if ((threadIdx.x & 31u) == (unsigned)(__ffs(am) - 1)) {
      active += (uint32_t)__popc(am);
      warp_steps += 1u;
    }
    steps += 1u;
    march += marching ? 1u : 0u;
  }
  __device__ __forceinline__ void lane() { lanes += 1u; }
  __device__ __forceinline__ void flush() {
    atomicAdd(&vol_counts[0], (unsigned long long)active);
    atomicAdd(&vol_counts[1], (unsigned long long)warp_steps);
    atomicAdd(&vol_counts[2], (unsigned long long)steps);
    atomicAdd(&vol_counts[3], (unsigned long long)march);
    atomicAdd(&vol_counts[4], (unsigned long long)lanes);
  }
};

// The counting builds' step counts: copied to the N_VOL_COUNTS uint64
// words at `out` (device memory) on `stream`, then zeroed where `reset`;
// returns cudaGetLastError().
extern "C" int step_counts(void* out, int reset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemcpyFromSymbolAsync(out, vol_counts, sizeof(vol_counts), 0,
                            cudaMemcpyDeviceToDevice, st);
  if (reset) {
    void* c = nullptr;
    cudaGetSymbolAddress(&c, vol_counts);
    cudaMemsetAsync(c, 0, sizeof(vol_counts), st);
  }
  return (int)cudaGetLastError();
}
#else
struct StepCounts {
  __device__ __forceinline__ void step(bool) {}
  __device__ __forceinline__ void lane() {}
  __device__ __forceinline__ void flush() {}
};
#endif

// Whether a lane takes this step of the loop, on the card: a lane whose
// bounce is due waits while another lane of its warp marches, so that
// the warp's lanes shade their bounces together ("march first"). Each
// lane makes the same draws, casts and sums in the same order either
// way; only when it makes them moves. Against every lane stepping
// freely, march first ran the fog mesh's 1280x720 megakernel launches
// 1.09-1.17x and fog_scene's 1.36-1.38x faster (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md section 6): once the lanes drift apart nearly every free
// step carries some lane's bounce shading, dearer than a march segment.
__device__ __forceinline__ bool step_now(bool marching) {
#ifdef __CUDACC__
  const bool any = __any_sync(__activemask(), marching);  // every lane votes
  return marching || !any;
#else
  (void)marching;
  return true;
#endif
}

// The march side of a lane loop: the last bounce's march queue, the march
// under way (number q), and the bounce's verdict and camera draws, which
// the caller applies when its marches end. The path ray itself (origin,
// direction, throughput, medium) is the caller's.
struct VolLoop {
  VolNee e;
  March m;
  int q;
  bool alive;
  float cj1, cj2;
};

// a loop before its first bounce, on the ray (o, d) in medium med
__device__ __forceinline__ void vol_loop_start(VolLoop& v, V3 o, V3 d,
                                               float med) {
  v.e.n_march = 0;
  v.m = march_start(o, d, med);
  v.q = 0;
  v.alive = false;
  v.cj1 = v.cj2 = 0.f;
}

// whether the loop's next step is a march segment
__device__ __forceinline__ bool vol_marching(const VolLoop& v) {
  return v.q < v.e.n_march;
}

// One step of the loop: the one cast, of the march segment where
// `marching` (vol_marching), else of the path ray (o, d) with throughput
// thr in medium med, which the step then shades with its draws (at():
// the Sobol pairs' sample index, pixel key and depth, taken there, after
// the cast) and replaces by the next ray; rays grows by ray_inc per
// bounce, the sums rad, an, aa as the bounce adds to them. When the
// bounce and its marches are done it calls done(): v.alive is then the
// bounce's verdict before the depth cut, v.cj1 and v.cj2 its camera
// draws. Whatever the caller needs of the lane only at shade time or at
// the bounce's end it computes there, in at() and done(), so that
// nothing of it stays live across the cast's walk.
template <bool MESH, bool SOBOL, class At, class Done>
__device__ __forceinline__ void vol_step(const Scene& s, const Media& md,
                                         bool beck, VolLoop& v,
                                         bool marching, V3& o, V3& d,
                                         float* thr, float& med,
                                         float& rays, float ray_inc,
                                         uint32_t& st, const At& at,
                                         float* rad, float* an, float* aa,
                                         const Done& done) {
  const Hit h = trace_closest<MESH>(s, marching ? v.m.o : o,
                                    marching ? v.m.d : d, TMIN);
  bool next;  // the queue's next march starts
  if (marching) {
    V3 tr;
    if (!march_seg(s, md, v.m, h, v.q >= s.n_lights, tr)) return;
    nee_add(s, md, beck, v.e, v.q, tr, rad);
    v.q = v.q + 1;
    next = v.q < v.e.n_march;
  } else {
    rays = rays + ray_inc;
    const SobolAt a = at();
    const VolDraws u = draw_bounce_vol<SOBOL>(s, st, a);
    const VolStep b = vol_shade<MESH>(s, md, beck, o, d, thr, med,
                                      a.depth == 0u, h, u, rad, an, aa, v.e);
    // the next ray now; the march origin is its origin
    v.alive = b.alive;
    o = b.o;
    d = b.d;
    for (int c = 0; c < 3; ++c) thr[c] = b.c[c];
    med = b.med;
    v.cj1 = b.cj1;
    v.cj2 = b.cj2;
    v.q = 0;
    next = v.e.n_march > 0;
  }
  if (next) {
    v.m = march_start(o, nee_dir(s, v.e, v.q), v.e.med);
    return;
  }
  // the bounce and its marches are done
  v.e.n_march = 0;
  done();
}
