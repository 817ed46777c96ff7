// Per-lane body of the path megakernel: camera, light sampling and the
// path loop of one pixel lane. Mirrors
// rene_tpu_torch/integrators/{camera,common,mega_path}.py
// (pallas_path.py:3439-3493, :4140-4161, :4266-4570). Included by
// mega_path.cu; plain C++ apart from the CUDA qualifiers and intrinsics.
#pragma once
#include <stdint.h>

#include "bsdf.cuh"
#include "intersect.cuh"
#include "layout.cuh"
#include "math.cuh"
#include "texture.cuh"

#define FLT_MIN_NORMAL 1.17549435e-38f  // the least normal float32

__device__ __forceinline__ float fjit(float u, float radius) {
  if (radius == 0.f) return u;
  float half = fminf(u, 1.f - u);
  float mag = 1.f - sqrtf(clamp_min(2.f * half, 0.f));
  return 0.5f + radius * (u < 0.5f ? -mag : mag);
}

__device__ __forceinline__ V3 camera_ray(const float* __restrict__ cam,
                                         float pxf, float pyf, float ju,
                                         float jv) {
  float r = __ldg(cam + CAM_FILTER);
  float u = (pxf + fjit(ju, r)) * __ldg(cam + CAM_INV_W1);
  float v = (pyf + fjit(jv, r)) * __ldg(cam + CAM_INV_H1);
  float nx = u * 2.f - 1.f;
  float ny = v * 2.f - 1.f;
  float tc[3], tw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* p = cam + CAM_PINV + 4 * k;
    tc[k] = __ldg(p) * nx + __ldg(p + 1) * ny + __ldg(p + 2) + __ldg(p + 3);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* c = cam + CAM_C2W + 4 * k;
    tw[k] = __ldg(c) * tc[0] + __ldg(c + 1) * tc[1] + __ldg(c + 2) * tc[2]
        + __ldg(c + 3);
  }
  return normalize3(v3(tw[0] - __ldg(cam + CAM_ORIGIN),
                       tw[1] - __ldg(cam + CAM_ORIGIN + 1),
                       tw[2] - __ldg(cam + CAM_ORIGIN + 2)));
}

// direction toward a sampled emitter point (pallas_path.py:3439)
__device__ __forceinline__ V3 sample_emit(const Scene& s, V3 p, float u_obj,
                                          float u_prim, float r, float sv) {
  bool flip = (r + sv) > 1.f;
  float rr = flip ? 1.f - r : r;
  float ss = flip ? 1.f - sv : sv;
  float w0 = 1.f - rr - ss;
  float eidx = floorf(u_obj * (float)(s.n_eo > 1 ? s.n_eo : 1));
  V3 q = v3(0.f, 0.f, 0.f), dir = v3(0.f, 0.f, 0.f);
  if (eidx < (float)s.n_eo) {
    const float* e = s.eo + (int)eidx * EO_W;
    if ((int)__ldg(e + EO_KIND) == KIND_TRIANGLE) {
      float cnt = __ldg(e + EO_COUNT);
      float pidx = floorf(u_prim * cnt);
      if (pidx < cnt) {
        const float* t = s.tris + (int)(__ldg(e + EO_START) + pidx) * TRI_W;
        q = v3(w0 * __ldg(t + TRI_V0) + rr * __ldg(t + TRI_V1)
                   + ss * __ldg(t + TRI_V2),
               w0 * __ldg(t + TRI_V0 + 1) + rr * __ldg(t + TRI_V1 + 1)
                   + ss * __ldg(t + TRI_V2 + 1),
               w0 * __ldg(t + TRI_V0 + 2) + rr * __ldg(t + TRI_V1 + 2)
                   + ss * __ldg(t + TRI_V2 + 2));
      }
    } else {
      V3 w = v3(__ldg(e + EO_CENTER) - p.x, __ldg(e + EO_CENTER + 1) - p.y,
                __ldg(e + EO_CENTER + 2) - p.z);
      float r2 = __ldg(e + EO_R2);
      float d2 = clamp_min(w.x * w.x + w.y * w.y + w.z * w.z, 1e-12f);
      float cos_max = sqrtf(clamp_min(1.f - r2 / d2, 0.f));
      float cos_t = d2 <= r2 ? 1.f - 2.f * r : 1.f - r * (1.f - cos_max);
      float sin_t = sqrtf(clamp_min(1.f - cos_t * cos_t, 0.f));
      float phi = TWO_PI_F * sv;
      w = normalize3(w);
      Frame f = onb_from_w(w);
      float cp = cosf(phi) * sin_t;
      float sp = sinf(phi) * sin_t;
      dir = v3(f.u.x * cp + f.v.x * sp + w.x * cos_t,
               f.u.y * cp + f.v.y * sp + w.y * cos_t,
               f.u.z * cp + f.v.z * sp + w.z * cos_t);
    }
  }
  if (!s.has_tri_emitter) return dir;
  V3 td = normalize3(v3(q.x - p.x, q.y - p.y, q.z - p.z));
  bool is_dir = dir.x != 0.f || dir.y != 0.f || dir.z != 0.f;
  return is_dir ? dir : td;
}

// the hit's material, its textured slots evaluated at the hit's uv
__device__ __forceinline__ Mat hit_material(const Scene& s, const Hit& h) {
  Mat m = load_mat(s.mats, h.mat);
  if (s.has_tex) {
    const float* r = s.mats + h.mat * MAT_W;
    if (__ldg(r + MAT_NTEX) > 0.f) apply_textures(r, s.atlas, m, h.u, h.v);
  }
  return m;
}

// A bounce's draws, in the stream contract's order: u_coin, u1, u2, ul;
// coin, ue1..ue4 when the scene has emitters or an env-map strategy, then
// upick when it has both; rrv when Russian roulette is on; cj1, cj2. A
// bounce draws them all exactly once, whether or not a branch uses them,
// and before its ray casts: drawn after them (to free thirteen registers
// during the tree walk) the chain of dependent xorshift steps no longer
// overlaps the casts' memory latency, which measured 1.5-3% slower on an
// NVIDIA H100 (700 W).
struct Draws {
  float u_coin, u1, u2, ul;
  float coin, ue1, ue2, ue3, ue4, upick;
  float rrv, cj1, cj2;
};

__device__ __forceinline__ Draws draw_bounce(const Scene& s, bool use_rr,
                                             uint32_t& st) {
  Draws u;
  u.u_coin = uniform(st);
  u.u1 = uniform(st);
  u.u2 = uniform(st);
  u.ul = uniform(st);
  u.coin = u.ue1 = u.ue2 = u.ue3 = u.ue4 = u.upick = u.rrv = 0.f;
  if (s.n_eo > 0 || s.has_env) {
    u.coin = uniform(st);
    u.ue1 = uniform(st);
    u.ue2 = uniform(st);
    u.ue3 = uniform(st);
    u.ue4 = uniform(st);
    if (s.n_eo > 0 && s.has_env) u.upick = uniform(st);
  }
  if (use_rr) u.rrv = uniform(st);
  u.cj1 = uniform(st);
  u.cj2 = uniform(st);
  return u;
}

// direction of the light sampler: an emit object, or the env map, picked
// with probability 1 / (E + 1) where the scene has both
__device__ __forceinline__ V3 sample_light(const Scene& s, V3 p,
                                           const Draws& u) {
  const int E = s.n_eo;
  if (s.has_env && (E == 0 || mul_rn(u.upick, (float)(E + 1)) < 1.f))
    return env_strategy(s.cam, s.env_mcdf, s.env_ccdf, u.ue1, u.ue2, u.ue3,
                        u.ue4);
  return sample_emit(s, p, u.ue1, u.ue2, u.ue3, u.ue4);
}

// solid-angle pdf of sample_light for direction w
__device__ __forceinline__ float light_pdf(const Scene& s, V3 p, V3 w) {
  const int E = s.n_eo;
  float lp = E > 0 ? trace_emit_pdf(s, p, w) : 0.f;
  if (s.has_env) lp = lp + env_pdf_dir(s.cam, s.env_pdf, w);
  return lp / (float)(E + (s.has_env ? 1 : 0));
}

struct Params {
  Scene s;
  int width, n_pix, max_depth, use_rr, beckmann, num_samples;
  int has_accel;   // launch the MESH variant
  int block_seed;  // seed streams per 32x32 pixel block (rng.tile_of)
  uint32_t seed;
  float* __restrict__ out;
};

// One lane's whole run: num_samples paths for pixel `lane`; writes the
// ten per-lane sums to out[k * n_pix + lane]. MESH: the scene has
// acceleration tables (mesh, instances or sphere table).
template <bool MESH>
__device__ __forceinline__ void trace_lane(const Params& p, int lane) {
  const Scene& s = p.s;
  const bool beck = p.beckmann != 0;
  const int E = s.n_eo;
  const float ray_inc = 1.f + (float)s.n_lights + (E > 0 ? 1.f : 0.f);
  const float pxf = (float)(lane % p.width);
  const float pyf = (float)(lane / p.width);
  const V3 cam_o = v3(__ldg(s.cam + CAM_ORIGIN), __ldg(s.cam + CAM_ORIGIN + 1),
                      __ldg(s.cam + CAM_ORIGIN + 2));
  const int bg_kind = (int)__ldg(s.cam + CAM_BG_KIND);
  const bool nee = E > 0 || s.has_env;

  uint32_t st = seed_state(
      (uint32_t)lane, p.seed,
      tile_of((uint32_t)lane, (uint32_t)p.width, p.block_seed != 0));
  float ju0 = uniform(st);
  float jv0 = uniform(st);
  V3 o = cam_o;
  V3 d = camera_ray(s.cam, pxf, pyf, ju0, jv0);
  float thr[3] = {1.f, 1.f, 1.f};
  float rad[3] = {0.f, 0.f, 0.f}, aov_n[3] = {0.f, 0.f, 0.f};
  float aov_a[3] = {0.f, 0.f, 0.f};
  float rays = 0.f;
  int depth = 0, sample = 0;

  while (sample < p.num_samples) {
    rays = rays + ray_inc;
    const Draws u = draw_bounce(s, p.use_rr != 0, st);
    Hit h = trace_closest<MESH>(s, o, d, TMIN);
    bool alive = h.t < BIG;
    V3 next_o = o, next_d = d;
    float nthr[3] = {thr[0], thr[1], thr[2]};
    if (!alive) {
      float bg[3];
      background(s.cam, s.atlas, bg_kind, d, bg);
      for (int c = 0; c < 3; ++c) rad[c] = rad[c] + thr[c] * bg[c];
    } else {
      Mat m = hit_material(s, h);
      V3 hp = v3(o.x + h.t * d.x, o.y + h.t * d.y, o.z + h.t * d.z);
      V3 n = normalize3(h.n);
      V3 wo = neg(d);
      Frame f = onb_from_w(n);
      // emitter hit (one-sided)
      if ((h.e[0] != 0.f || h.e[1] != 0.f || h.e[2] != 0.f) && dot3(wo, n) > 0.f)
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
          rad[c] = rad[c] + thr[c] * fe.f[c] * cosl * __ldg(L + LIGHT_COLOR + c);
      }
      // scatter
      BsdfSample bs = bsdf_sample(m, lo, u.u_coin, u.u1, u.u2, u.ul, beck);
      V3 sw = to_world(f, bs.wi);
      V3 w_ = sw;
      float fv[3] = {bs.f[0], bs.f[1], bs.f[2]};
      float pdf = bs.pdf;
      if (nee && is_diffuse(m)) {
        // one-sample MIS between the light and BSDF strategies
        V3 ls = sample_light(s, hp, u);
        BsdfVal fe = bsdf_eval(m, lo, to_local(f, ls), beck);
        bool take_light = u.coin > 0.5f;
        float pdf_b = bs.pdf;
        if (take_light) {
          w_ = ls;
          for (int c = 0; c < 3; ++c) fv[c] = fe.f[c];
          pdf_b = fe.pdf;
        }
        pdf = 0.5f * pdf_b + 0.5f * light_pdf(s, hp, w_);
      }
      alive = pdf >= 1e-5f;
      float cosw = fabsf(w_.x * n.x + w_.y * n.y + w_.z * n.z);
      float scale = cosw / clamp_min(pdf, 1e-20f);
      for (int c = 0; c < 3; ++c) nthr[c] = thr[c] * fv[c] * scale;
      // a throughput below the normal range counts as zero, as under the
      // flush-to-zero arithmetic of XLA and the TPU
      alive = alive && maxn(nthr[0], maxn(nthr[1], nthr[2])) >= FLT_MIN_NORMAL;
      if (p.use_rr) {
        float p_cont = clampn(maxn(nthr[0], maxn(nthr[1], nthr[2])), 0.f, 1.f);
        bool do_rr = depth > RR_START;
        alive = alive && (!do_rr || u.rrv <= p_cont);
        if (do_rr && alive) {
          float inv_p = 1.f / clamp_min(p_cont, 1e-20f);
          for (int c = 0; c < 3; ++c) nthr[c] = nthr[c] * inv_p;
        }
      }
      next_o = hp;
      next_d = w_;
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
        o = cam_o;
        d = camera_ray(s.cam, pxf, pyf, u.cj1, u.cj2);
        thr[0] = thr[1] = thr[2] = 1.f;
        depth = 0;
      }
    }
  }

  const size_t N = (size_t)p.n_pix;
  float* out = p.out + lane;
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
