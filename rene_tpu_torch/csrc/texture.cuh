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
// bits and would not agree with the plain version. Every product and sum
// that decides which texel, checker square or env cell a lane reads, and
// the blend of the four texels, is rounded on its own (mul_rn, sub_rn,
// add_rn), as the plain version rounds it (nvcc would contract them into
// FMAs): a fetch is bit for bit the plain version's. A material's slots
// are walked class by class in a loop that is not unrolled; a class whose
// image is the previous image class's (TEXD_SAME, set by the host: a
// roughness map bound to both uroughness and vroughness) takes that
// fetch's value. The env-map searches start from each cdf's guide table
// (guided_search): one or two loads where a binary search took six or
// seven dependent ones. The entry points are inlined where a bounce calls
// them: as real calls they cost their callers spills and registers in
// every build, textured or not (PERF.md section 6). Each kernel holds an
// instance without texture code (template parameter TEX, path.cuh
// without_tex), which scenes that run none launch.
// Measured and left out (PERF.md section 6): the atlas in 4 x 4-texel
// tiles, whose bilinear footprint touches fewer sectors, ran the
// textured mesh's 16-spp launch 8.5% slower than the flat atlas with the
// same blend, reuse and searches; the 34.6 MB atlas fits the card's L2
// either way.
#pragma once
#include <stdint.h>

#include "bsdf.cuh"
#include "layout.cuh"
#include "math.cuh"

// What the texture calls of a launch did, kept only by the -DTEX_COUNT=1
// build (`mega_path_mesh_texcount`, which `python -m rene_tpu_torch.probe
// --scene textured_mesh` alone launches), summed over the launch into
// tex_counts (TEX_KEYS in rene_tpu_torch/kernels.py): image fetches by
// slot class and of the background, fetches of the image a row's
// previous image class fetched at the same uv, checker evaluations, env
// strategy draws and env_pdf_dir calls; per entry point (apply_textures,
// textured_background, env_strategy, env_pdf_dir) the lanes of a warp
// active at its entry (its leader adds __popc(__activemask())) and the
// warp entries; the clock cycles inside the calls, and the threads'
// cycles (the kernel adds them). Each event is summed over the lanes of
// its warp that meet it together, so one atomic per warp.
#define N_TEX_COUNTS 22
#define TEXC_FETCH 0   // + slot class; the background's at + 7
#define TEXC_REPEAT 8
#define TEXC_CHECKER 9
#define TEXC_ENV_DRAW 10
#define TEXC_ENV_PDF 11
#define TEXC_ENTRY 12  // + 2 * entry point: lanes, then warps
#define TEXC_CYCLES 20
#define TEXC_LANE_CYCLES 21
#define TEX_APPLY 0
#define TEX_BG 1
#define TEX_DRAW 2
#define TEX_PDF 3
#if defined(TEX_COUNT) && TEX_COUNT
__device__ unsigned long long tex_counts[N_TEX_COUNTS];
__device__ __forceinline__ long long tex_clock() { return clock64(); }
// v summed over the warp's active lanes, added by its leader
__device__ __forceinline__ void tex_count(int i, uint32_t v = 1u) {
  const unsigned am = __activemask();
  const uint32_t s = __reduce_add_sync(am, v);
  if ((threadIdx.x & 31u) == (unsigned)(__ffs(am) - 1))
    atomicAdd(tex_counts + i, (unsigned long long)s);
}
// at a call's entry: its active lanes and one warp entry; its clock
__device__ __forceinline__ long long tex_enter(int entry) {
  const unsigned am = __activemask();
  if ((threadIdx.x & 31u) == (unsigned)(__ffs(am) - 1)) {
    atomicAdd(tex_counts + TEXC_ENTRY + 2 * entry,
              (unsigned long long)__popc(am));
    atomicAdd(tex_counts + TEXC_ENTRY + 2 * entry + 1, 1ull);
  }
  return tex_clock();
}
__device__ __forceinline__ void tex_leave(long long t0) {
  tex_count(TEXC_CYCLES, (uint32_t)(tex_clock() - t0));
}
__device__ __forceinline__ void tex_lane_cycles(long long t0) {
  atomicAdd(tex_counts + TEXC_LANE_CYCLES,
            (unsigned long long)(tex_clock() - t0));
}
// The counting build's counts: copied to the N_TEX_COUNTS uint64 words at
// `out` (device memory) on `stream`, then zeroed where `reset`; returns
// cudaGetLastError().
extern "C" int tex_counts_read(void* out, int reset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemcpyFromSymbolAsync(out, tex_counts, sizeof(tex_counts), 0,
                            cudaMemcpyDeviceToDevice, st);
  if (reset) {
    void* c = nullptr;
    cudaGetSymbolAddress(&c, tex_counts);
    cudaMemsetAsync(c, 0, sizeof(tex_counts), st);
  }
  return (int)cudaGetLastError();
}
#else
__device__ __forceinline__ void tex_count(int, uint32_t = 1u) {}
__device__ __forceinline__ long long tex_enter(int) { return 0; }
__device__ __forceinline__ void tex_leave(long long) {}
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
// computed in float32 as yy * wf + xx, as the reference computes it; a
// uv that is not finite reads the image's first texel, as the plain
// version reads it.
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
    int idx = (flat >= 0.f && flat <= (float)last) ? (int)flat : 0;
    rgb9e5_decode(__ldg(img + idx), c[j]);
  }
  // the weights' products and sums rounded one by one, as the plain
  // version rounds them: the fetch gives its value bit for bit
  const float gx = sub_rn(1.f, fx), gy = sub_rn(1.f, fy);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float top = add_rn(mul_rn(c[0][ch], gx), mul_rn(c[1][ch], fx));
    float bot = add_rn(mul_rn(c[2][ch], gx), mul_rn(c[3][ch], fx));
    rgb[ch] = add_rn(mul_rn(top, gy), mul_rn(bot, fy));
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
// in class order (`apply_images`). A class whose image is the previous
// image class's (TEXD_SAME, set by the host) takes that fetch's value,
// the same value at the same uv, without fetching.
__device__ __forceinline__ void apply_textures(
    const float* __restrict__ r, const uint32_t* __restrict__ atlas, Mat& m,
    float u, float v) {
  const long long t0 = tex_enter(TEX_APPLY);
  const bool rrm = __ldg(r + MAT_RRM) > 0.5f;
#pragma unroll 1
  for (int i = 0; i < N_TEX_CLASSES; ++i) {
    int cls = i < 4 ? i : (i < 6 ? i + 1 : 4);
    const float* d = r + MAT_TEX + cls * TEXD_W;
    if ((int)__ldg(d + TEXD_KIND) != TEXK_CHECKER) continue;
    tex_count(TEXC_CHECKER);
    bool even = checker_even(u, v, __ldg(d + TEXD_US), __ldg(d + TEXD_VS));
    const float* q = d + (even ? TEXD_EVEN : TEXD_ODD);
    float val[3] = {__ldg(q), __ldg(q + 1), __ldg(q + 2)};
    set_slot(m, cls, val, false, false);
  }
  float val[3] = {0.f, 0.f, 0.f};   // the last image fetched
#pragma unroll 1
  for (int cls = 0; cls < N_TEX_CLASSES; ++cls) {
    const float* d = r + MAT_TEX + cls * TEXD_W;
    if ((int)__ldg(d + TEXD_KIND) != TEXK_IMAGE) continue;
    if (__ldg(d + TEXD_SAME) > 0.5f) {
      tex_count(TEXC_REPEAT);
    } else {
      tex_count(TEXC_FETCH + cls);
      fetch_image(atlas, __ldg(d + TEXD_OFF), __ldg(d + TEXD_IW),
                  __ldg(d + TEXD_IH), u, v, val);
    }
    set_slot(m, cls, val, true, rrm);
  }
  tex_leave(t0);
}

// a vector through the row-major 3x3 at m
__device__ __forceinline__ V3 rot3(const float* __restrict__ m, V3 a) {
  return v3(__ldg(m) * a.x + __ldg(m + 1) * a.y + __ldg(m + 2) * a.z,
            __ldg(m + 3) * a.x + __ldg(m + 4) * a.y + __ldg(m + 5) * a.z,
            __ldg(m + 6) * a.x + __ldg(m + 7) * a.y + __ldg(m + 8) * a.z);
}

// the env image or the checker at the spherical uv of background_matrix d
__device__ __forceinline__ void textured_background(
    const float* __restrict__ cam, const uint32_t* __restrict__ atlas,
    int kind, V3 d, float* val) {
  const long long t0 = tex_enter(TEX_BG);
  float u, v;
  sphere_uv_of(rot3(cam + CAM_BG_MAT, d), u, v);
  if (kind == BG_IMAGE) {
    tex_count(TEXC_FETCH + N_TEX_CLASSES);
    fetch_image(atlas, __ldg(cam + CAM_BG_IMG), __ldg(cam + CAM_BG_IMG + 1),
                __ldg(cam + CAM_BG_IMG + 2), u, v, val);
  } else {
    const float* q = cam + CAM_BG_CHK;
    bool even = checker_even(u, v, __ldg(q), __ldg(q + 1));
    for (int c = 0; c < 3; ++c) val[c] = __ldg(q + (even ? 2 : 5) + c);
  }
  tex_leave(t0);
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
// index of the first of the n entries at cdf that is >= x, capped at n -
// 1 (the reference's lower-bound search), through the cdf's guide table:
// its entry b, the first index whose value is >= b / ENV_GUIDE, is at or
// before the answer for every x >= b / ENV_GUIDE (b = floor(x ENV_GUIDE),
// exact in float32), so a scan from it finds the answer, over the cells
// whose cdf values fall in the guide's bucket: one or two loads where the
// distribution has mass. A negative or NaN x starts at entry 0, whose
// first index has a value >= 0 and is the answer.
__device__ __forceinline__ int guided_search(const float* __restrict__ cdf,
                                             int n,
                                             const uint8_t* __restrict__ guide,
                                             float x) {
  const int b = x >= 0.f
      ? (int)fminf(x * (float)ENV_GUIDE, (float)(ENV_GUIDE - 1)) : 0;
  int i = __ldg(guide + b);
  while (i < n - 1 && __ldg(cdf + i) < x) ++i;
  return i;
}

// a world direction drawn from the env grid distribution: the cell from
// (x1, x2), a uniform point in it from (x3, x4), then through the inverse
// background matrix
__device__ __forceinline__ V3 env_strategy(
    const float* __restrict__ cam, const float* __restrict__ mcdf,
    const float* __restrict__ ccdf, const uint8_t* __restrict__ guide,
    float x1, float x2, float x3, float x4) {
  const long long t0 = tex_enter(TEX_DRAW);
  tex_count(TEXC_ENV_DRAW);
  int r = guided_search(mcdf, ENV_GH, guide, x1);
  int cc = guided_search(ccdf + r * ENV_GW, ENV_GW,
                         guide + (1 + r) * ENV_GUIDE, x2);
  float theta = mul_rn(add_rn((float)r, x3), (float)(PI_D / ENV_GH));
  float phi = mul_rn(add_rn((float)cc, x4), (float)(2.0 * PI_D / ENV_GW));
  float stn = sinf(theta);
  const V3 w = normalize3(rot3(cam + CAM_BG_INV, v3(stn * cosf(phi),
                                                    stn * sinf(phi),
                                                    cosf(theta))));
  tex_leave(t0);
  return w;
}

// solid-angle pdf with which env_strategy draws direction w
__device__ __forceinline__ float env_pdf_dir(const float* __restrict__ cam,
                                             const float* __restrict__ pdf,
                                             V3 w) {
  const long long t0 = tex_enter(TEX_PDF);
  tex_count(TEXC_ENV_PDF);
  V3 dl = normalize3(rot3(cam + CAM_BG_MAT, w));
  float theta = atan2_approx(
      sqrtf(clamp_min(sub_rn(1.f, mul_rn(dl.z, dl.z)), 0.f)), dl.z);
  float phi = atan2_approx(dl.y, dl.x);
  if (phi < 0.f) phi = add_rn(phi, TWO_PI_F);
  int r = (int)mul_rn(theta, (float)(ENV_GH / PI_D));
  int cc = (int)mul_rn(phi, (float)(ENV_GW / (2.0 * PI_D)));
  r = r < 0 ? 0 : (r > ENV_GH - 1 ? ENV_GH - 1 : r);
  cc = cc < 0 ? 0 : (cc > ENV_GW - 1 ? ENV_GW - 1 : cc);
  const float pd = __ldg(pdf + r * ENV_GW + cc);
  tex_leave(t0);
  return pd;
}
