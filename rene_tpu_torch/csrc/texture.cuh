// Per-hit textures, the textured background and the env-map sampler of the
// path kernels (slice K1b), per thread. Mirrors
// rene_tpu_torch/ops/texture.py, which mirrors
// rene_tpu/integrators/pallas_path.py: `_rgb9e5_dec` :1775, `fetch_image`
// :1797, `atan2_approx` :1918, `sphere_uv_of` :1938, the env strategy
// :1967-2050, the checker of `_apply_rec_texs` :2713, `_remap_rough_k`
// :4164 and `apply_images` :4171.
//
// Design. The TPU kernel sweeps 8-row pages of a VMEM atlas with lane
// gathers and select chains, because Mosaic has no per-lane gather. A CUDA
// thread gathers: the atlas is one flat array of RGB9E5 words in global
// memory, the images back to back, and a thread reads its four texels
// through the read-only cache and decodes them with integer shifts. No
// texture object: the hardware's bilinear filter weighs with 8 fractional
// bits and would not agree with the plain version. A material's slots are
// walked class by class in a loop that is not unrolled, so that the fetch
// code exists once; only materials that have a textured slot enter it.
// The entry points a bounce calls (apply_textures, textured_background,
// env_strategy, env_pdf_dir) are real calls (TEX_CALL), not inlined: the
// body of a bounce, which every scene runs, stays the code it was, and a
// scene without textures never makes the calls.
// What bounds it: four dependent 4-byte loads per fetch, scattered for
// incoherent bounces. The products that decide which texel or which
// checker square a lane reads are rounded on their own (mul_rn, sub_rn),
// as the plain version rounds them: nvcc would contract them into FMAs.
#pragma once
#include <stdint.h>

#include "bsdf.cuh"
#include "layout.cuh"
#include "math.cuh"

#ifdef __CUDACC__
#define TEX_CALL __device__ __noinline__
#else
#define TEX_CALL static
#endif

// r, g, b of an RGB9E5 word: m * 2^(e - 24) per channel, exact
__device__ __forceinline__ void rgb9e5_decode(uint32_t w, float* rgb) {
  float scale = __uint_as_float((((w >> 27) & 31u) + 103u) << 23);
  rgb[0] = (float)(w & 511u) * scale;
  rgb[1] = (float)((w >> 9) & 511u) * scale;
  rgb[2] = (float)((w >> 18) & 511u) * scale;
}

// REPEAT addressing of a whole-numbered texel coordinate
__device__ __forceinline__ float wrap_texel(float a, float m) {
  m = fmaxf(m, 1.f);
  return a - floorf(a / m) * m;
}

// Bilinear REPEAT fetch at (u, v), v flipped, from the image of wf x hf
// texels whose first texel is word `off` of the atlas. The texel index is
// computed in float32 as yy * wf + xx, as the reference computes it.
__device__ __forceinline__ void fetch_image(const uint32_t* __restrict__ atlas,
                                            float off, float wf, float hf,
                                            float u, float v, float* rgb) {
  float x = sub_rn(mul_rn(u, wf), 0.5f);
  float y = sub_rn(mul_rn(sub_rn(1.f, v), hf), 0.5f);
  float x0 = floorf(x), y0 = floorf(y);
  float fx = x - x0, fy = y - y0;
  float xs[2] = {wrap_texel(x0, wf), wrap_texel(x0 + 1.f, wf)};
  float ys[2] = {wrap_texel(y0, hf), wrap_texel(y0 + 1.f, hf)};
  int last = (int)(wf * hf) - 1;
  last = last > 0 ? last : 0;
  const uint32_t* img = atlas + (int)off;
  float c[4][3];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float flat = ys[j >> 1] * wf + xs[j & 1];
    // a uv that is not finite reads a texel of its own image
    int idx = (flat >= 0.f && flat <= (float)last) ? (int)flat : 0;
    rgb9e5_decode(__ldg(img + idx), c[j]);
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float top = c[0][ch] * (1.f - fx) + c[1][ch] * fx;
    float bot = c[2][ch] * (1.f - fx) + c[3][ch] * fx;
    rgb[ch] = top * (1.f - fy) + bot * fy;
  }
}

// on an even square of a checkerboard of us x vs squares per unit uv
__device__ __forceinline__ bool checker_even(float u, float v, float us,
                                             float vs) {
  float xs = mul_rn(u, us), ys = mul_rn(v, vs);
  return (sub_rn(xs, 2.f * floorf(0.5f * xs)) < 1.f)
      == (sub_rn(ys, 2.f * floorf(0.5f * ys)) < 1.f);
}

// atan2 by octant reduction and the Cephes atanf polynomial on
// [0, tan(pi / 8)], as the reference kernel computes it; every step
// rounded on its own, so that uv and env cells fall where the plain
// version's fall
__device__ __forceinline__ float atan2_approx(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  bool swap = ay > ax;
  float num = fminf(ax, ay);
  float den = fmaxf(fmaxf(ax, ay), 1e-30f);
  float t = num / den;
  bool hi = t > 0.41421356237f;
  if (hi) t = sub_rn(t, 1.f) / add_rn(t, 1.f);
  float z = mul_rn(t, t);
  float w = sub_rn(mul_rn(add_rn(mul_rn(sub_rn(mul_rn(8.05374449538e-2f, z),
                                               1.38776856032e-1f), z),
                                 1.99777106478e-1f), z),
                   3.33329491539e-1f);
  float a = add_rn(mul_rn(mul_rn(w, z), t), t);
  if (hi) a = add_rn(a, (float)(PI_D / 4.0));
  if (swap) a = sub_rn((float)(PI_D / 2.0), a);
  if (x < 0.f) a = sub_rn(PI_F, a);
  return y < 0.f ? -a : a;
}

// spherical (u, v) of a direction or a unit-sphere local point:
// u = phi / 2 pi, v = 1 - theta / pi
__device__ __forceinline__ void sphere_uv_of(V3 p, float& u, float& v) {
  V3 n = normalize3(p);
  float theta = atan2_approx(
      sqrtf(clamp_min(sub_rn(1.f, mul_rn(n.z, n.z)), 0.f)), n.z);
  float phi = atan2_approx(n.y, n.x);
  if (phi < 0.f) phi = add_rn(phi, TWO_PI_F);
  u = mul_rn(phi, (float)(0.5 / PI_D));
  v = mul_rn(sub_rn(theta, PI_F), (float)(-1.0 / PI_D));
}

// pbrt's roughness -> alpha polynomial, per hit
__device__ __forceinline__ float remap_rough(float r) {
  float x = logf(clamp_min(r, 1e-3f));
  return 1.62142f + 0.819955f * x + 0.1734f * x * x
      + 0.0171201f * (x * x * x) + 0.000640711f * ((x * x) * (x * x));
}

// store the per-hit value `val` of slot class `cls` (kd, ks, ru, rv, op,
// kr, kt) into the material: `scale` multiplies the attribute by it (an
// image), otherwise it replaces the attribute (a checker). Opacity v sets
// op = 1 - v and multiplies Kr and Kt either way.
__device__ __forceinline__ void set_slot(Mat& m, int cls, const float* val,
                                         bool scale, bool rrm) {
  switch (cls) {
    case 0:
      for (int c = 0; c < 3; ++c) m.ab[c] = scale ? m.ab[c] * val[c] : val[c];
      break;
    case 1:
      for (int c = 0; c < 3; ++c) m.k[c] = scale ? m.k[c] * val[c] : val[c];
      break;
    case 2:
    case 3: {
      float& a = cls == 2 ? m.ax : m.ay;
      float r = scale ? a * val[0] : val[0];
      a = (scale && rrm) ? remap_rough(r) : r;
      break;
    }
    case 4:
      for (int c = 0; c < 3; ++c) {
        m.op[c] = 1.f - val[c];
        m.kr2[c] = m.kr2[c] * val[c];
        m.kt2[c] = m.kt2[c] * val[c];
      }
      break;
    case 5:
      for (int c = 0; c < 3; ++c)
        m.kr2[c] = scale ? m.kr2[c] * val[c] : val[c];
      break;
    default:
      for (int c = 0; c < 3; ++c)
        m.kt2[c] = scale ? m.kt2[c] * val[c] : val[c];
  }
}

// Evaluate the textured slots of material row `r` at (u, v) into m: every
// checker first, the opacity's last (`_apply_rec_texs`), then every image
// in class order (`apply_images`).
TEX_CALL void apply_textures(const float* __restrict__ r,
                             const uint32_t* __restrict__ atlas, Mat& m,
                             float u, float v) {
  const bool rrm = __ldg(r + MAT_RRM) > 0.5f;
#pragma unroll 1
  for (int i = 0; i < N_TEX_CLASSES; ++i) {
    int cls = i < 4 ? i : (i < 6 ? i + 1 : 4);
    const float* d = r + MAT_TEX + cls * TEXD_W;
    if ((int)__ldg(d + TEXD_KIND) != TEXK_CHECKER) continue;
    bool even = checker_even(u, v, __ldg(d + TEXD_US), __ldg(d + TEXD_VS));
    const float* q = d + (even ? TEXD_EVEN : TEXD_ODD);
    float val[3] = {__ldg(q), __ldg(q + 1), __ldg(q + 2)};
    set_slot(m, cls, val, false, false);
  }
#pragma unroll 1
  for (int cls = 0; cls < N_TEX_CLASSES; ++cls) {
    const float* d = r + MAT_TEX + cls * TEXD_W;
    if ((int)__ldg(d + TEXD_KIND) != TEXK_IMAGE) continue;
    float val[3];
    fetch_image(atlas, __ldg(d + TEXD_OFF), __ldg(d + TEXD_IW),
                __ldg(d + TEXD_IH), u, v, val);
    set_slot(m, cls, val, true, rrm);
  }
}

// a vector through the row-major 3x3 at m
__device__ __forceinline__ V3 rot3(const float* __restrict__ m, V3 a) {
  return v3(__ldg(m) * a.x + __ldg(m + 1) * a.y + __ldg(m + 2) * a.z,
            __ldg(m + 3) * a.x + __ldg(m + 4) * a.y + __ldg(m + 5) * a.z,
            __ldg(m + 6) * a.x + __ldg(m + 7) * a.y + __ldg(m + 8) * a.z);
}

// the env image or the checker at the spherical uv of background_matrix d
TEX_CALL void textured_background(const float* __restrict__ cam,
                                  const uint32_t* __restrict__ atlas,
                                  int kind, V3 d, float* val) {
  float u, v;
  sphere_uv_of(rot3(cam + CAM_BG_MAT, d), u, v);
  if (kind == BG_IMAGE) {
    fetch_image(atlas, __ldg(cam + CAM_BG_IMG), __ldg(cam + CAM_BG_IMG + 1),
                __ldg(cam + CAM_BG_IMG + 2), u, v, val);
  } else {
    const float* q = cam + CAM_BG_CHK;
    bool even = checker_even(u, v, __ldg(q), __ldg(q + 1));
    for (int c = 0; c < 3; ++c) val[c] = __ldg(q + (even ? 2 : 5) + c);
  }
}

// miss radiance along d: the constant CAM_BG, times the textured
// background's value there
__device__ __forceinline__ void background(const float* __restrict__ cam,
                                           const uint32_t* __restrict__ atlas,
                                           int kind, V3 d, float* rgb) {
  for (int c = 0; c < 3; ++c) rgb[c] = __ldg(cam + CAM_BG + c);
  if (kind == BG_CONST) return;
  float val[3];
  textured_background(cam, atlas, kind, d, val);
  for (int c = 0; c < 3; ++c) rgb[c] = val[c] * rgb[c];
}

// ---- env-map importance sampling ------------------------------------------
// index of the first of the n (a power of two) entries at cdf that is
// >= x, capped at n - 1: the reference's probes, lo + step - 1 for
// step = n / 2 .. 1
__device__ __forceinline__ int lower_bound(const float* __restrict__ cdf,
                                           int n, float x) {
  int lo = 0;
  for (int step = n >> 1; step; step >>= 1)
    if (__ldg(cdf + lo + step - 1) < x) lo += step;
  return lo < n - 1 ? lo : n - 1;
}

// a world direction drawn from the env grid distribution: the cell from
// (x1, x2), a uniform point in it from (x3, x4), then through the inverse
// background matrix
TEX_CALL V3 env_strategy(const float* __restrict__ cam,
                         const float* __restrict__ mcdf,
                         const float* __restrict__ ccdf, float x1, float x2,
                         float x3, float x4) {
  int r = lower_bound(mcdf, ENV_GH, x1);
  int cc = lower_bound(ccdf + r * ENV_GW, ENV_GW, x2);
  float theta = mul_rn(add_rn((float)r, x3), (float)(PI_D / ENV_GH));
  float phi = mul_rn(add_rn((float)cc, x4), (float)(2.0 * PI_D / ENV_GW));
  float stn = sinf(theta);
  return normalize3(rot3(cam + CAM_BG_INV,
                         v3(stn * cosf(phi), stn * sinf(phi), cosf(theta))));
}

// solid-angle pdf with which env_strategy draws direction w
TEX_CALL float env_pdf_dir(const float* __restrict__ cam,
                           const float* __restrict__ pdf, V3 w) {
  V3 dl = normalize3(rot3(cam + CAM_BG_MAT, w));
  float theta = atan2_approx(
      sqrtf(clamp_min(sub_rn(1.f, mul_rn(dl.z, dl.z)), 0.f)), dl.z);
  float phi = atan2_approx(dl.y, dl.x);
  if (phi < 0.f) phi = add_rn(phi, TWO_PI_F);
  int r = (int)mul_rn(theta, (float)(ENV_GH / PI_D));
  int cc = (int)mul_rn(phi, (float)(ENV_GW / (2.0 * PI_D)));
  r = r < 0 ? 0 : (r > ENV_GH - 1 ? ENV_GH - 1 : r);
  cc = cc < 0 ? 0 : (cc > ENV_GW - 1 ? ENV_GW - 1 : cc);
  return __ldg(pdf + r * ENV_GW + cc);
}
