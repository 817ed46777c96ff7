// Per-thread vector math and the lane random stream of the path
// megakernel. Mirrors rene_tpu_torch/ops/{vec3,rng}.py.
#pragma once
#include <stdint.h>

#define BIG 3e38f
#define TMIN 1e-3f
// python-float constants of the JAX kernel, rounded once to float32
#define PI_D 3.141592653589793
#define PI_F ((float)PI_D)
#define INV_PI_F ((float)(1.0 / PI_D))
#define TWO_PI_F ((float)(2.0 * PI_D))

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r = {x, y, z};
  return r;
}
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 load3(const float* __restrict__ p) {
  return v3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

// a product, sum or difference rounded on its own, as torch's eager
// operations round it: nvcc contracts a * b + c into one FMA otherwise.
// For arithmetic that cancels badly (the sphere tests), where one
// rounding step flips an outcome or moves a hit.
#ifdef __CUDACC__
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
#else
inline float mul_rn(float a, float b) { return a * b; }
inline float add_rn(float a, float b) { return a + b; }
inline float sub_rn(float a, float b) { return a - b; }
#endif

// four floats from a 16-byte aligned table row: one vector load on the
// card, four scalar loads where the headers compile as plain C++
#ifdef __CUDACC__
__device__ __forceinline__ float4 load4(const float* __restrict__ p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
#else
struct float4 {
  float x, y, z, w;
};
inline float4 load4(const float* p) {
  float4 r = {p[0], p[1], p[2], p[3]};
  return r;
}
#endif

// max/clamp that keep a NaN input, as torch.clamp and jnp.maximum do
// (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return (x != x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return (x != x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clampn(float x, float lo, float hi) {
  return (x != x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float maxn(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ V3 normalize3(V3 a) {
  float inv = rsqrtf(clamp_min(a.x * a.x + a.y * a.y + a.z * a.z, 1e-20f));
  return v3(a.x * inv, a.y * inv, a.z * inv);
}

struct Frame {
  V3 u, v, n;
};

__device__ __forceinline__ Frame onb_from_w(V3 n) {
  bool x_major = fabsf(n.x) > fabsf(n.y);
  float inv = rsqrtf(clamp_min(x_major ? n.x * n.x + n.z * n.z
                                   : n.y * n.y + n.z * n.z, 1e-20f));
  V3 u = v3((x_major ? -n.z : 0.f) * inv, (x_major ? 0.f : n.z) * inv,
            (x_major ? n.x : -n.y) * inv);
  V3 v = v3(n.y * u.z - n.z * u.y, n.z * u.x - n.x * u.z,
            n.x * u.y - n.y * u.x);
  Frame f = {u, v, n};
  return f;
}

__device__ __forceinline__ V3 to_local(const Frame& f, V3 a) {
  return v3(a.x * f.u.x + a.y * f.u.y + a.z * f.u.z,
            a.x * f.v.x + a.y * f.v.y + a.z * f.v.z,
            a.x * f.n.x + a.y * f.n.y + a.z * f.n.z);
}

__device__ __forceinline__ V3 to_world(const Frame& f, V3 a) {
  return v3(a.x * f.u.x + a.y * f.v.x + a.z * f.n.x,
            a.x * f.u.y + a.y * f.v.y + a.z * f.n.y,
            a.x * f.u.z + a.y * f.v.z + a.z * f.n.z);
}

// xorshift32 lane stream (rene_tpu_torch/ops/rng.py): seeded per lane id
// (the pixel, or pix + slot * n_pix where a pixel has `pack` sample slots)
// and per TPU grid step `tile` (rng.tile_of: the 8192-lane step, or the bs
// x bs pixel block in cluster mode), drawn through the mantissa bitcast
__device__ __forceinline__ uint32_t tile_of(uint32_t pix, uint32_t width,
                                            bool blocks, uint32_t bs) {
  if (!blocks) return pix / 8192u;
  uint32_t bw = (width + bs - 1u) / bs;
  return (pix / width / bs) * bw + (pix % width) / bs;
}

__device__ __forceinline__ uint32_t seed_state(uint32_t lane, uint32_t seed,
                                               uint32_t tile) {
  uint32_t seed_u = seed + tile * 65537u;
  return ((lane * 2654435761u) ^ seed_u) | 1u;
}

__device__ __forceinline__ float uniform(uint32_t& st) {
  st ^= st << 13;
  st ^= st >> 17;
  st ^= st << 5;
  return __uint_as_float((st >> 9) | 0x3F800000u) - 1.0f;
}
