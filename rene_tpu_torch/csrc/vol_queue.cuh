// The block's march queue of the volpath megakernel (K1e,
// mega_lane.cuh vol_warp_step). A lane whose bounce queued NEE marches
// (volpath.cuh VolNee) does not walk them itself: it puts each, with the
// weight its sum takes (nee_add at a transmittance of 1), in a slot of a
// queue in the block's shared memory and goes on with its path. Warps of
// the block take up to 32 queued marches at once and run each to its
// end, segment by segment (medium.cuh march_seg over trace_closest, as
// the inline loop runs them, so the transmittance has the same bits),
// then hand back its sum, transmittance times weight, through the slot.
// The owner adds the sums to an NEE sum of its own in the order it put
// the marches, whichever warp ran them and whenever they end, so a lane's
// sums are the same from run to run; its radiance is that NEE sum added
// to the rest at the end. So a march no longer keeps the lanes of its
// owner's warp waiting a step per segment while two or three lanes of 32
// walk: the block's marches walk 32 at a time.
//
// The bookkeeping: lane t owns QUEUE_SLOTS slots, j * QUEUE_LANES + t,
// used in turn (a ring: `head` the oldest out, `out` how many are); a
// lane whose slots are all out puts nothing until the oldest comes back.
// `pend` holds a bit per slot queued and not yet taken, word w the slots
// 32 w .. 32 w + 31. A warp takes marches by clearing their bits with
// atomicAnd (`queue_take`): whatever bits it cleared are its own,
// however warps race. States of a slot: JOB_IDLE, then JOB_QUEUED (with
// JOB_EMIT where the march wants the emitter, medium.cuh march_seg) from
// `queue_put` until the runner's `queue_finish` writes the sum and
// JOB_DONE, then JOB_IDLE again when its owner takes the sum
// (`queue_sum`).
//
// Plain C++ apart from the CUDA qualifiers and intrinsics: on the CPU the
// atomics are plain read-modify-writes and the fences nothing, for a
// sequential stand-in of the warps (tests/test_torch_kernel_source.py).
#pragma once
#include <stdint.h>

#include "medium.cuh"

#define QUEUE_LANES 128   // a block's threads
// slots a lane owns: with one, a lane that scatters again before its
// march has come back waits. Swept with the block floor (mega_path.cu):
// at six blocks 2 / 4 slots 45.77 / 47.53 ms, at eight 2 / 3 / 4 slots
// 49.14 / 46.51 / 52.76, at twelve 1 / 2 slots 68.74 / 60.94
#define QUEUE_SLOTS 2
#define QUEUE_JOBS (QUEUE_LANES * QUEUE_SLOTS)
#define QUEUE_WORDS (QUEUE_JOBS / 32)
#define QUEUE_BATCH 32    // a warp's lanes
#define QUEUE_FIELDS 10

enum : uint32_t { JOB_IDLE = 0, JOB_QUEUED = 1, JOB_EMIT = 2, JOB_DONE = 4 };

// In the block's shared memory, after the immediates' cast rows
// (intersect.cuh stage_imm). A job, field by field over the slots so that
// a warp's 32 slots fall in 32 banks: origin xyz, direction xyz, medium,
// weight rgb; the weight's three hold the sum once JOB_DONE.
struct MarchQueue {
  float f[QUEUE_FIELDS][QUEUE_JOBS];
  uint32_t state[QUEUE_JOBS];
  uint32_t pend[QUEUE_WORDS];
  uint32_t got[QUEUE_LANES / 32][QUEUE_WORDS];  // warp w's last take, by
                                                // word from its own on
};

#ifdef __CUDACC__
#define QUEUE_FENCE() __threadfence_block()
#define QV volatile
__device__ __forceinline__ uint32_t queue_and(uint32_t* a, uint32_t v) {
  return atomicAnd(a, v);
}
__device__ __forceinline__ void queue_or(uint32_t* a, uint32_t v) {
  atomicOr(a, v);
}
// the place of the n-th (from 0) set bit of m, which has more than n
__device__ __forceinline__ int nth_bit(uint32_t m, int n) {
  return (int)__fns(m, 0u, n + 1);
}
#else
#define QUEUE_FENCE() ((void)0)
#define QV
inline uint32_t queue_and(uint32_t* a, uint32_t v) {
  const uint32_t old = *a;
  *a = old & v;
  return old;
}
inline void queue_or(uint32_t* a, uint32_t v) { *a |= v; }
inline int nth_bit(uint32_t m, int n) {
  for (int b = 0; b < 32; ++b)
    if (((m >> b) & 1u) && n-- == 0) return b;
  return -1;
}
#endif

__device__ __forceinline__ int count_bits(uint32_t m) {
#ifdef __CUDACC__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// lane t's part of an empty queue; every thread calls it before the
// block's first barrier
__device__ __forceinline__ void queue_init(MarchQueue& q, int t) {
  for (int j = 0; j < QUEUE_SLOTS; ++j)
    q.state[j * QUEUE_LANES + t] = JOB_IDLE;
  if (t < QUEUE_WORDS) q.pend[t] = 0u;
  if (t < QUEUE_LANES / 32)
    for (int k = 0; k < QUEUE_WORDS; ++k) q.got[t][k] = 0u;
}

// lane t's j-th slot
__device__ __forceinline__ int queue_slot_of(int t, int j) {
  return j * QUEUE_LANES + t;
}

// a lane queues in `slot` the march from o along d in medium med whose
// sum takes weight w; its warp then publishes it (queue_publish)
__device__ __forceinline__ void queue_put(MarchQueue& q, int slot, V3 o,
                                          V3 d, float med, bool want_emit,
                                          const float* w) {
  QV float* f = &q.f[0][0];
  const float v[QUEUE_FIELDS] = {o.x, o.y, o.z, d.x, d.y, d.z, med,
                                 w[0], w[1], w[2]};
  for (int k = 0; k < QUEUE_FIELDS; ++k) f[k * QUEUE_JOBS + slot] = v[k];
  ((QV uint32_t*)q.state)[slot] = JOB_QUEUED | (want_emit ? JOB_EMIT : 0u);
  QUEUE_FENCE();
}

// one lane of a warp: the slots of `bits` in word `word` (bit k: slot
// 32 word + k), which its lanes have put, become takeable
__device__ __forceinline__ void queue_publish(MarchQueue& q, int word,
                                              uint32_t bits) {
  queue_or(&q.pend[word], bits);
}

// marches queued and not yet taken
__device__ __forceinline__ int queue_pending(MarchQueue& q) {
  int n = 0;
  for (int k = 0; k < QUEUE_WORDS; ++k)
    n += count_bits(((QV uint32_t*)q.pend)[k]);
  return n;
}

// One lane of warp w: where at least QUEUE_BATCH marches are queued, or
// where any are and none of the warp's lanes has a bounce due (`ready`,
// so that a warp whose lanes cannot go on always drains), take up to
// QUEUE_BATCH of them, from word w on. Returns how many it took; q.got[w]
// says which.
__device__ __forceinline__ int queue_take(MarchQueue& q, int w, int ready) {
  const int pending = queue_pending(q);
  if (pending == 0 || (pending < QUEUE_BATCH && ready > 0)) return 0;
  int n = 0;
  for (int k = 0; k < QUEUE_WORDS; ++k) {
    uint32_t* word = &q.pend[(w + k) % QUEUE_WORDS];
    const uint32_t m = *(QV uint32_t*)word;
    const int room = QUEUE_BATCH - n;
    uint32_t pick = m;
    if (count_bits(m) > room)  // the lowest `room` bits of m
      pick = room > 0 ? m & ((1u << nth_bit(m, room)) - 1u) : 0u;
    const uint32_t got = pick ? pick & queue_and(word, ~pick) : 0u;
    q.got[w][k] = got;
    n += count_bits(got);
  }
  QUEUE_FENCE();
  return n;
}

// the slot of the j-th (from 0) march of warp w's last take, which took
// more than j
__device__ __forceinline__ int queue_taken(const MarchQueue& q, int w,
                                           int j) {
  for (int k = 0; k < QUEUE_WORDS; ++k) {
    const uint32_t g = ((const QV uint32_t*)q.got[w])[k];
    const int c = count_bits(g);
    if (j < c) return 32 * ((w + k) % QUEUE_WORDS) + nth_bit(g, j);
    j -= c;
  }
  return -1;
}

// the march queued in `slot`, as march_start begins it, and whether it
// wants the emitter
__device__ __forceinline__ March queue_job(const MarchQueue& q, int slot,
                                           bool& want_emit) {
  const QV float* f = &q.f[0][0];
  want_emit = (((const QV uint32_t*)q.state)[slot] & JOB_EMIT) != 0u;
  return march_start(v3(f[0 * QUEUE_JOBS + slot], f[1 * QUEUE_JOBS + slot],
                        f[2 * QUEUE_JOBS + slot]),
                     v3(f[3 * QUEUE_JOBS + slot], f[4 * QUEUE_JOBS + slot],
                        f[5 * QUEUE_JOBS + slot]),
                     f[6 * QUEUE_JOBS + slot]);
}

// the runner of the march in `slot` hands back its sum: transmittance tr
// times the slot's weight
__device__ __forceinline__ void queue_finish(MarchQueue& q, int slot, V3 tr) {
  QV float* f = &q.f[7][slot];
  f[0] = tr.x * f[0];
  f[QUEUE_JOBS] = tr.y * f[QUEUE_JOBS];
  f[2 * QUEUE_JOBS] = tr.z * f[2 * QUEUE_JOBS];
  QUEUE_FENCE();
  ((QV uint32_t*)q.state)[slot] = JOB_DONE;
}

// whether the march in `slot` has come back
__device__ __forceinline__ bool queue_done(const MarchQueue& q, int slot) {
  return ((const QV uint32_t*)q.state)[slot] == JOB_DONE;
}

// the sum of the march in `slot`, once queue_done, added to nee; the slot
// is free again
__device__ __forceinline__ void queue_sum(MarchQueue& q, int slot,
                                          float* nee) {
  QUEUE_FENCE();
  const QV float* f = &q.f[7][slot];
  nee[0] = nee[0] + f[0];
  nee[1] = nee[1] + f[QUEUE_JOBS];
  nee[2] = nee[2] + f[2 * QUEUE_JOBS];
  ((QV uint32_t*)q.state)[slot] = JOB_IDLE;
}

#ifdef __CUDACC__
// the block's queue, in its dynamic shared memory after the immediates'
// cast rows (a multiple of 16 bytes); the launch adds sizeof(MarchQueue)
__device__ __forceinline__ MarchQueue& march_queue(const Scene& s) {
  return *reinterpret_cast<MarchQueue*>(
      reinterpret_cast<char*>(imm_shared) + IMM_BYTES(s));
}

// The card's warp for vol_warp_step (mega_lane.cuh): this thread's lane
// state L, the collectives over the whole warp, which every thread of it
// reaches (the loop keeps the warp's 32 threads together, those past the
// launch's lanes too). The CPU tests' stand-in runs a warp's 32 lane
// states one after another behind the same calls.
template <class Lane>
struct CardWarp {
  Lane& L;
  int t;  // threadIdx.x
  __device__ __forceinline__ int warp() const { return t >> 5; }
  // f(L, t) on each lane, no collective
  template <class F>
  __device__ __forceinline__ void each(const F& f) { f(L, t); }
  // the warp's ballot of f(L, t), which may change L
  template <class F>
  __device__ __forceinline__ uint32_t ballot(const F& f) {
    return __ballot_sync(0xffffffffu, f(L, t));
  }
  // f() on one lane, after the warp's earlier writes; its value to all
  template <class F>
  __device__ __forceinline__ uint32_t once(const F& f) {
    __syncwarp();
    uint32_t r = 0u;
    if ((t & 31) == 0) r = f();
    __syncwarp();
    return __shfl_sync(0xffffffffu, r, 0);
  }
  // nothing to do while other warps run this warp's marches
  __device__ __forceinline__ void idle() { __nanosleep(100); }
};
#endif
