// The megakernel's lane loop: one thread streams a pixel's paths back to
// back through the path body (K1a-K1d, pallas_path.py `body` :4349;
// `path_lane`) or, where VOL, the volpath body (K1e, `body_vol` :4572;
// `vol_lane`, the state machine of vol_loop.cuh). Mirrors
// rene_tpu_torch/integrators/mega_path.py `path_lanes_ref` (and
// volpath.py `vol_lanes_ref`). Included by mega_path.cu; plain C++ apart
// from the CUDA qualifiers and intrinsics.
// SOBOL: the instance of `Sampler "sobol"` (K-sobol, csrc/sobol.cuh),
// whose bounce draws are Sobol pairs of the lane's sample index and depth
// under its pixel's key (pallas_path.py:4328-4341, :4437-4542).
#pragma once
#include <stdint.h>

#include "path.cuh"
#include "vol_loop.cuh"
#include "vol_queue.cuh"

struct Params {
  Scene s;
  int width, n_pix, max_depth, use_rr, beckmann, num_samples;
  int has_accel;   // launch the MESH variant
  int block_seed;  // seed streams per pixel block (rng.tile_of)
  int block;       // the block's edge, 32 / sqrt(pack) (rng.block_edge)
  int n_lanes;     // the launch's lanes, n_run * pack: `pack` sample slots
                   // per pixel (K1f)
  int pix0, n_run;  // the launch's pixels, [pix0, pix0 + n_run): every
                    // pixel of the film (0, n_pix) but in a tiles-mode
                    // rank's launch (parallel/shard.py)
  int sobol;       // launch the SOBOL instance
  uint32_t seed;
  float* __restrict__ out;
  const float* __restrict__ media;  // (n_media, MED_W), read by volpath
  int n_media;
};

// Where lane `lane` starts (integrators/mega_path.py lane_start): its
// pixel, lane % n_pix, at sample slot lane / n_pix; its xorshift32 state,
// seeded by the lane id and its grid step (the 8192-lane step of the
// pixel, or in cluster mode the pixel's bs x bs block); its Sobol key, of
// the pixel and the step's seed mixed with the slot (pallas_path.py
// :4307-4337)
struct LaneStart {
  uint32_t pix, st, key;
};

__device__ __forceinline__ LaneStart lane_start(uint32_t lane, uint32_t n_pix,
                                                uint32_t width, bool blocks,
                                                uint32_t bs, uint32_t seed) {
  const uint32_t pix = lane % n_pix, slot = lane / n_pix;
  const uint32_t tile = tile_of(pix, width, blocks, bs);
  const uint32_t seed_u = seed + tile * 65537u;
  return {pix, seed_state(lane, seed, tile),
          sob_pixkey(pix, seed_u ^ (slot * 0x9E3779B1u))};
}

// A lane's start: its pixel's coordinates, its stream, its Sobol key
// (0 for the independent sampler) and its first camera ray, from the
// camera origin `o`.
struct Lane {
  float pxf, pyf;
  uint32_t st, pixkey;
  V3 o, d;
};

template <bool SOBOL>
__device__ __forceinline__ Lane lane_begin(const Params& p, int lane) {
  const Scene& s = p.s;
  const LaneStart ls =
      lane_start((uint32_t)lane, (uint32_t)p.n_pix, (uint32_t)p.width,
                 p.block_seed != 0, (uint32_t)p.block, p.seed);
  Lane l;
  l.pxf = (float)(ls.pix % (uint32_t)p.width);
  l.pyf = (float)(ls.pix / (uint32_t)p.width);
  l.o = v3(__ldg(s.cam + CAM_ORIGIN), __ldg(s.cam + CAM_ORIGIN + 1),
           __ldg(s.cam + CAM_ORIGIN + 2));
  l.st = ls.st;
  l.pixkey = 0u;
  float ju0, jv0;
  if constexpr (SOBOL) {
    l.pixkey = ls.key;
    ld2(0u, l.pixkey, 0u, SLOT_CAM, ju0, jv0);
  } else {
    ju0 = uniform(l.st);
    jv0 = uniform(l.st);
  }
  l.d = camera_ray(s.cam, l.pxf, l.pyf, ju0, jv0);
  return l;
}

// The lane id of the launch's i-th lane: slot i / n_run of pixel pix0 +
// i % n_run, slot-major as over the whole film, where it is lane i
__device__ __forceinline__ int lane_of(const Params& p, int i) {
  return (i / p.n_run) * p.n_pix + p.pix0 + i % p.n_run;
}

// the ten per-lane sums of lane id `lane`, to out[k * n_lanes + i] where
// i is its place in the launch (`lane_of`)
__device__ __forceinline__ void write_sums(const Params& p, int lane,
                                           const float* rad,
                                           const float* aov_n,
                                           const float* aov_a, float rays) {
  const size_t N = (size_t)p.n_lanes;
  float* out = p.out + (size_t)(lane / p.n_pix) * p.n_run
               + (lane % p.n_pix - p.pix0);
  out[0 * N] = rad[0];
  out[1 * N] = rad[1];
  out[2 * N] = rad[2];
  out[3 * N] = aov_n[0];
  out[4 * N] = aov_n[1];
  out[5 * N] = aov_n[2];
  out[6 * N] = aov_a[0];
  out[7 * N] = aov_a[1];
  out[8 * N] = aov_a[2];
  out[9 * N] = rays;
}

// One lane's whole run through the path body: num_samples paths for
// pixel lane % n_pix (sample slot lane / n_pix). MESH: the scene has
// acceleration tables (mesh, instances or sphere table). SOBOL: the draws
// of the path body and the camera are Sobol pairs keyed by the pixel, the
// grid-step seed and the slot.
template <bool MESH, bool SOBOL>
__device__ __forceinline__ void path_lane(const Params& p, int lane) {
  const Scene& s = p.s;
  const bool beck = p.beckmann != 0;
  const int E = s.n_eo;
  const float ray_inc = 1.f + (float)s.n_lights + (E > 0 ? 1.f : 0.f);
  Lane l = lane_begin<SOBOL>(p, lane);
  const float pxf = l.pxf, pyf = l.pyf;
  const V3 cam_o = l.o;
  const int bgk = bg_kind(s);
  uint32_t st = l.st;
  const uint32_t pixkey = l.pixkey;
  V3 o = cam_o;
  V3 d = l.d;
  float thr[3] = {1.f, 1.f, 1.f};
  float rad[3] = {0.f, 0.f, 0.f}, aov_n[3] = {0.f, 0.f, 0.f};
  float aov_a[3] = {0.f, 0.f, 0.f};
  float rays = 0.f;
  int depth = 0, sample = 0;

  while (sample < p.num_samples) {
    rays = rays + ray_inc;
    bool alive;
    V3 next_o = o, next_d = d;
    float nthr[3] = {thr[0], thr[1], thr[2]};
    float cj1, cj2;
    const SobolAt at = {(uint32_t)sample, pixkey, (uint32_t)depth};
    path_bounce();
    long long t0 = path_clock();
    const Draws u = draw_bounce_as<SOBOL>(s, p.use_rr != 0, st, at);
    path_add(PH_DRAW, t0);
    cj1 = u.cj1;
    cj2 = u.cj2;
    t0 = path_clock();
    Hit h = trace_closest<MESH>(s, o, d, TMIN);
    path_add(PH_TRACE, t0);
    alive = h.t < BIG;
    if (!alive) {
      float bg[3];
      background(s.cam, s.atlas, bgk, d, bg);
      for (int c = 0; c < 3; ++c) rad[c] = rad[c] + thr[c] * bg[c];
    } else {
      Mat m = hit_material(s, h);
      V3 hp = v3(o.x + h.t * d.x, o.y + h.t * d.y, o.z + h.t * d.z);
      V3 n = normalize3(h.n);
      V3 wo = neg(d);
      Frame f = onb_from_w(n);
      // emitter hit (one-sided)
      if ((h.e[0] != 0.f || h.e[1] != 0.f || h.e[2] != 0.f)
          && dot3(wo, n) > 0.f)
        for (int c = 0; c < 3; ++c) rad[c] = rad[c] + thr[c] * h.e[c];
      // AOVs at depth 0
      if (depth == 0) {
        aov_n[0] = aov_n[0] + n.x;
        aov_n[1] = aov_n[1] + n.y;
        aov_n[2] = aov_n[2] + n.z;
        for (int c = 0; c < 3; ++c) aov_a[c] = aov_a[c] + m.ab[c];
      }
      V3 lo = to_local(f, wo);
      // distant lights: NEE with a shadow ray each
      for (int li = 0; li < s.n_lights; ++li) {
        const float* L = s.lights + li * LIGHT_W;
        V3 ld = load3(L + LIGHT_DIR);
        if (shadow_any<MESH>(s, li, hp, ld, TMIN, 1e5f)) continue;
        BsdfVal fe = bsdf_eval(m, lo, to_local(f, ld), beck);
        float cosl = fabsf(ld.x * n.x + ld.y * n.y + ld.z * n.z);
        for (int c = 0; c < 3; ++c)
          rad[c] = rad[c]
              + thr[c] * fe.f[c] * cosl * __ldg(L + LIGHT_COLOR + c);
      }
      t0 = path_clock();
      alive = bsdf_step(s, m, f, n, lo, hp, u, beck, thr, next_d, nthr);
      path_add(PH_BSDF, t0);
      // a throughput below the normal range counts as zero, as under
      // the flush-to-zero arithmetic of XLA and the TPU
      alive = alive
          && maxn(nthr[0], maxn(nthr[1], nthr[2])) >= FLT_MIN_NORMAL;
      if (p.use_rr) {
        float p_cont = clampn(maxn(nthr[0], maxn(nthr[1], nthr[2])), 0.f,
                              1.f);
        bool do_rr = depth > RR_START;
        alive = alive && (!do_rr || u.rrv <= p_cont);
        if (do_rr && alive) {
          float inv_p = 1.f / clamp_min(p_cont, 1e-20f);
          for (int c = 0; c < 3; ++c) nthr[c] = nthr[c] * inv_p;
        }
      }
      next_o = hp;
    }
    alive = alive && (depth + 1 < p.max_depth);
    if (alive) {
      o = next_o;
      d = next_d;
      for (int c = 0; c < 3; ++c) thr[c] = nthr[c];
      depth = depth + 1;
    } else {
      sample = sample + 1;
      if (sample < p.num_samples) {  // regenerate a camera path
        if constexpr (SOBOL)
          ld2((uint32_t)sample, pixkey, 0u, SLOT_CAM, cj1, cj2);
        o = cam_o;
        d = camera_ray(s.cam, pxf, pyf, cj1, cj2);
        thr[0] = thr[1] = thr[2] = 1.f;
        depth = 0;
      }
    }
  }

  write_sums(p, lane, rad, aov_n, aov_a, rays);
}

// The end of a volpath bounce and of its marches in the queued loop
// (vol_warp_step): the depth cut decides between the next bounce and a
// new camera path from lane l's pixel (the bounce's verdict v.alive, its
// camera draws v.cj1, v.cj2; SOBOL: the camera's Sobol pair at the next
// sample). vol_lane keeps its own copy of these lines, as vol_step keeps
// its shade's (vol_loop.cuh vol_bounce), so that the inline loop compiles
// to the SASS it had before the queue.
template <bool SOBOL>
__device__ __forceinline__ void vol_path_next(const Params& p,
                                              const VolLoop& v,
                                              const Lane& l, V3& o, V3& d,
                                              float* thr, float& med,
                                              int& depth, int& sample) {
  if (v.alive && depth + 1 < p.max_depth) {
    depth = depth + 1;
    return;
  }
  sample = sample + 1;
  if (sample < p.num_samples) {  // regenerate a camera path
    float cj1 = v.cj1, cj2 = v.cj2;
    if constexpr (SOBOL)
      ld2((uint32_t)sample, l.pixkey, 0u, SLOT_CAM, cj1, cj2);
    o = l.o;
    d = camera_ray(p.s.cam, l.pxf, l.pyf, cj1, cj2);
    thr[0] = thr[1] = thr[2] = 1.f;
    med = 0.f;
    depth = 0;
  }
}

// One lane's whole run through the volpath body (K1e) with its marches
// inline: num_samples paths for pixel lane % n_pix (sample slot lane /
// n_pix), each starting in vacuum, one ray cast per step of vol_loop.cuh's
// state machine (vol_step); when a bounce's last march has ended, or it
// queued none, the depth cut decides between the next bounce and a new
// camera path. SOBOL: the path body's and the camera's draws are Sobol
// pairs at (sample, pixel key, depth); the medium's stay on the stream.
template <bool MESH, bool SOBOL>
__device__ __forceinline__ void vol_lane(const Params& p, int lane) {
  const Scene& s = p.s;
  const Media md = {p.media, p.n_media};
  const bool beck = p.beckmann != 0;
  const float ray_inc = 1.f + (float)s.n_lights + (s.n_eo > 0 ? 1.f : 0.f);
  Lane l = lane_begin<SOBOL>(p, lane);
  V3 o = l.o, d = l.d;
  float thr[3] = {1.f, 1.f, 1.f};
  float rad[3] = {0.f, 0.f, 0.f}, aov_n[3] = {0.f, 0.f, 0.f};
  float aov_a[3] = {0.f, 0.f, 0.f};
  float rays = 0.f, med = 0.f;
  int depth = 0, sample = 0;
  VolLoop v;
  vol_loop_start(v, o, d, med);
  StepCounts cnt;
  cnt.lane();

  while (sample < p.num_samples) {
    const bool marching = vol_marching(v);
    if (!step_now(marching)) continue;
    cnt.step(marching);
    vol_step<MESH, SOBOL>(
        s, md, beck, v, marching, o, d, thr, med, rays, ray_inc, l.st,
        [&] {
          return SobolAt{(uint32_t)sample, l.pixkey, (uint32_t)depth};
        },
        rad, aov_n, aov_a, [&] {
          if (v.alive && depth + 1 < p.max_depth) {
            depth = depth + 1;
          } else {
            sample = sample + 1;
            if (sample < p.num_samples) {  // regenerate a camera path
              float cj1 = v.cj1, cj2 = v.cj2;
              if constexpr (SOBOL)
                ld2((uint32_t)sample, l.pixkey, 0u, SLOT_CAM, cj1, cj2);
              o = l.o;
              d = camera_ray(s.cam, l.pxf, l.pyf, cj1, cj2);
              thr[0] = thr[1] = thr[2] = 1.f;
              med = 0.f;
              depth = 0;
            }
          }
        });
  }
  cnt.flush();
  write_sums(p, lane, rad, aov_n, aov_a, rays);
}

// One lane's whole run with the inline loop: the path body or, where VOL,
// the volpath body; writes the ten per-lane sums (`write_sums`).
template <bool MESH, bool VOL, bool SOBOL>
__device__ __forceinline__ void trace_lane(const Params& p, int lane) {
  if constexpr (VOL)
    vol_lane<MESH, SOBOL>(p, lane);
  else
    path_lane<MESH, SOBOL>(p, lane);
}

// Whether the volpath megakernel runs its instance that marches through
// the block's queue (vol_queue.cuh, vol_warp_step) or the one that marches
// inline (vol_lane), by the scene's tables: on immediates with emitters
// and without distant lights, where a bounce marches only at a scatter
// point toward the emitters, a few lanes of a warp at a time (the Cornell
// smoke scene: ~3.4 of 32 a march step); with a distant light every
// surface bounce marches, the lanes of a warp together, and march-first
// keeps them so at the cost of no bookkeeping (PERF.md section 6: the fog
// scene's launch 1.45x slower through the queue); without emitters
// nothing marches. The mesh builds march inline.
template <bool MESH>
inline bool vol_queues(const Scene& s) {
  return !MESH && s.n_lights == 0 && s.n_eo > 0;
}

// A lane of the queued loop (vol_warp_step): its run as vol_lane holds it
// and its NEE sum (nee), the ring of its queue slots, and the march it
// runs for the block's queue, another lane's or its own.
struct QLane {
  Lane l;
  V3 o, d;
  float thr[3], rad[3], an[3], aa[3], nee[3];
  float rays, med;
  int depth, sample;
  VolLoop v;   // its bounce's NEE marches (v.q: the next to put) and
               // verdict; v.m unused
  int head;    // its oldest slot out (ring index)
  int out;     // its slots out
  March m;     // the march it runs for the queue
  int slot;    // m's slot, or -1
  bool emit;   // m wants the emitter
  bool live;   // a lane of the launch: i < n_lanes
  StepCounts cnt;
};

// the queued loop's lane of the launch's i-th thread; past n_lanes, a lane
// with no samples, which only helps its warp along
template <bool SOBOL>
__device__ __forceinline__ void qlane_begin(const Params& p, int i,
                                            QLane& L) {
  L.live = i < p.n_lanes;
  L.l = Lane{};
  if (L.live) L.l = lane_begin<SOBOL>(p, lane_of(p, i));
  L.o = L.l.o;
  L.d = L.l.d;
  for (int c = 0; c < 3; ++c) {
    L.thr[c] = 1.f;
    L.rad[c] = L.an[c] = L.aa[c] = L.nee[c] = 0.f;
  }
  L.rays = L.med = 0.f;
  L.depth = 0;
  L.sample = L.live ? 0 : p.num_samples;
  vol_loop_start(L.v, L.o, L.d, L.med);
  L.head = L.out = 0;
  L.m = L.v.m;
  L.slot = -1;
  L.emit = false;
  if (L.live) L.cnt.lane();
}

// One step of a warp of the queued volpath loop (K1e): its lanes run as
// vol_lane's, but a lane whose bounce queued NEE marches puts them in the
// block's march queue (vol_queue.cuh), one a step in its queue's order,
// each with its weight (nee_add at a transmittance of 1), and goes on
// once the last is in (vol_path_next); it adds their sums to its NEE sum
// in that order as they come back. So every lane makes the same draws and
// casts as in vol_lane, and sums in an order of its own. A step:
//  - each lane takes the sums of its marches that came back, oldest
//    first, and puts its bounce's next march where it has a slot free;
//  - one cast, from one call site: where the warp holds marches from the
//    queue, their next segments (medium.cuh march_seg), until all have
//    ended; else, where the queue holds a warp's worth, or any and none of
//    the warp's lanes has a bounce due, it takes up to 32 (queue_take) and
//    casts their first segments; else the path rays of the lanes whose
//    bounce is due, which it shades (vol_bounce).
// Warp `w` (the card's CardWarp, or the CPU tests' stand-in) runs each
// lane's part and the warp's ballots. Returns false once the warp's lanes
// have run their samples and have no march out, true after a step or,
// where its lanes wait on marches other warps run, after idling.
template <bool MESH, bool SOBOL, class W>
__device__ __forceinline__ bool vol_warp_step(const Params& p,
                                              MarchQueue& q, W& w) {
  const Scene& s = p.s;
  const Media md = {p.media, p.n_media};
  const bool beck = p.beckmann != 0;
  const float ray_inc = 1.f + (float)s.n_lights + (s.n_eo > 0 ? 1.f : 0.f);
  const int wid = w.warp();
  // sums back, oldest first; the bounce's next march in
  const uint32_t put = w.ballot([&](QLane& L, int t) {
    while (L.out > 0 && queue_done(q, queue_slot_of(t, L.head))) {
      queue_sum(q, queue_slot_of(t, L.head), L.nee);
      L.head = (L.head + 1) % QUEUE_SLOTS;
      L.out = L.out - 1;
    }
    if (L.v.q >= L.v.e.n_march || L.out == QUEUE_SLOTS) return false;
    float wt[3] = {0.f, 0.f, 0.f};
    nee_add(s, md, beck, L.v.e, L.v.q, v3(1.f, 1.f, 1.f), wt);
    const int j = (L.head + L.out) % QUEUE_SLOTS;
    queue_put(q, queue_slot_of(t, j), L.o, nee_dir(s, L.v.e, L.v.q),
              L.v.e.med, L.v.q >= s.n_lights, wt);
    L.out = L.out + 1;
    L.v.q = L.v.q + 1;
    if (L.v.q == L.v.e.n_march) {  // the bounce's marches are all in
      L.v.e.n_march = 0;
      vol_path_next<SOBOL>(p, L.v, L.l, L.o, L.d, L.thr, L.med, L.depth,
                           L.sample);
    }
    return true;
  });
  // published by ring index j, the slots of one word
  if (put) {
    for (int j = 0; j < QUEUE_SLOTS; ++j) {
      const uint32_t bits = QUEUE_SLOTS == 1 ? put : put & w.ballot(
          [&](const QLane& L, int) {
            return (L.head + L.out - 1) % QUEUE_SLOTS == j;
          });
      if (bits) w.once([&] {
        queue_publish(q, (j * QUEUE_LANES) / 32 + wid, bits);
        return 0u;
      });
    }
  }
  uint32_t act = w.ballot([](const QLane& L, int) { return L.slot >= 0; });
  bool marching = act != 0u;
  if (!marching) {
    const uint32_t ready = w.ballot([&](const QLane& L, int) {
      return L.v.q >= L.v.e.n_march && L.sample < p.num_samples;
    });
    const int n = (int)w.once([&] {
      return (uint32_t)queue_take(q, wid, count_bits(ready));
    });
    if (n == 0 && !ready) {
      if (!w.ballot([](const QLane& L, int) {
            return L.out > 0 || L.v.q < L.v.e.n_march;
          }))
        return false;
      w.idle();
      return true;
    }
    act = ready;
    if (n > 0) {
      w.each([&](QLane& L, int t) {
        const int j = t & 31;
        if (j >= n) return;
        L.slot = queue_taken(q, wid, j);
        L.m = queue_job(q, L.slot, L.emit);
      });
      act = n == 32 ? ~0u : (1u << n) - 1u;
      marching = true;
    }
  }
  // the one cast: the marches' next segments, or the due bounces
  w.each([&](QLane& L, int t) {
    if (!((act >> (t & 31)) & 1u)) return;
    L.cnt.at(act, marching, marching);
    const Hit h = trace_closest<MESH>(s, marching ? L.m.o : L.o,
                                      marching ? L.m.d : L.d, TMIN);
    if (marching) {
      V3 tr;
      if (march_seg(s, md, L.m, h, L.emit, tr)) {
        queue_finish(q, L.slot, tr);
        L.slot = -1;
      }
      return;
    }
    vol_bounce<MESH, SOBOL>(
        s, md, beck, L.v, h, L.o, L.d, L.thr, L.med, L.rays, ray_inc, L.l.st,
        [&] {
          return SobolAt{(uint32_t)L.sample, L.l.pixkey, (uint32_t)L.depth};
        },
        L.rad, L.an, L.aa);
    if (L.v.e.n_march == 0)  // else its marches go in first
      vol_path_next<SOBOL>(p, L.v, L.l, L.o, L.d, L.thr, L.med, L.depth,
                           L.sample);
  });
  return true;
}

// the queued loop's radiance sum of lane L: its NEE sum added to the rest
__device__ __forceinline__ void qlane_sums(const QLane& L, float* rad) {
  for (int c = 0; c < 3; ++c) rad[c] = L.rad[c] + L.nee[c];
}

#ifdef __CUDACC__
// The queued loop's run of the launch's i-th thread, in the block's march
// queue q: its lane's (lane_of) sums where i < n_lanes. Every thread of
// the block calls it, those past n_lanes too.
template <bool MESH, bool SOBOL>
__device__ __forceinline__ void vol_queue_lane(const Params& p, int i,
                                               MarchQueue& q) {
  QLane L;
  qlane_begin<SOBOL>(p, i, L);
  CardWarp<QLane> w{L, (int)threadIdx.x};
  while (vol_warp_step<MESH, SOBOL>(p, q, w)) {
  }
  L.cnt.flush();
  float rad[3];
  qlane_sums(L, rad);
  if (L.live) write_sums(p, lane_of(p, i), rad, L.an, L.aa, L.rays);
}
#endif
