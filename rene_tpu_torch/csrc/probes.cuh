// Per-thread parts of the probe kernels of csrc/probes.cu, plain C++
// apart from the CUDA qualifiers, so that tests/test_torch_probes.py
// compiles them with g++ and holds them to rene_tpu_torch/ops/probes.py:
// the P-r3n group index, the P-r3w chain, and the fragment and
// shared-memory index maps that place P-r3w's products on the tensor
// cores.
#pragma once
#include <stdint.h>

#include "math.cuh"

#define R3N_GROWS 2    // box rows per group (tpu_session_r3n.py `grows`)
#define R3N_LANES 128  // columns of a box row and of a geom block
#define R3N_ROWS 8     // geom rows, the (8, 128) output
#define R3W_STEPS 32   // unrolled steps of k_vpu's body
#define R3W_K 8        // columns of the (M, 8) table b
#define R3W_WG_ROWS 24   // rows of b a warpgroup takes in hi (wgmma N)
#define R3W_MMA_TILES 2  // 16 x 8 tiles a warp takes in def (mma.sync)
// the shared-memory layout of a wgmma B operand (K-major, no swizzle):
// 8 x 16-byte core matrices, R3W_LBO bytes apart along k, R3W_SBO bytes
// apart from one group of 8 columns of the product to the next
#define R3W_LBO 128
#define R3W_SBO 256

// a loop unrolled by nvcc; plain to the host compiler of the tests
#ifdef __CUDACC__
#define R3W_UNROLL _Pragma("unroll")
#else
#define R3W_UNROLL
#endif

// jnp.minimum / jnp.maximum: a NaN input gives a NaN (fminf and fmaxf
// would drop it). On the card one instruction each (PTX min.NaN /
// max.NaN, sm_80 and later, FMNMX.NAN); elsewhere the tests and selects
// of math.cuh maxn
#ifdef __CUDA_ARCH__
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
#else
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return maxn(a, b);
}
#endif

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// P-r3n (scripts/tpu_session_r3n.py k_p1 / k_p2 / k_p3, :46-66): the
// 128-column block of geom that probe `mode` reads for group si. The
// group's two box rows start at row 2 * si (mode 3: si offset by the
// octant of geom's lane (0, 0) minus 3, less 7); its block index is box
// column 126 as a float truncated to int (modes 1, 3) or column 127's
// int32 bits (mode 2). A slice start past its table's end is clamped
// into it, as lax.dynamic_slice (and so JAX's interpret mode) clamps.
__device__ __forceinline__ int rowslice_group(int mode, int si,
                                              const float* box, int box_rows,
                                              const float* geom,
                                              int geom_cols) {
  if (mode == 3) {
    const int neg = (__ldg(geom) - 3.0f) < 0.f ? 1 : 0;
    si = si + (4 * neg + 2 * neg + neg) - 7;
  }
  const int row = clampi(si * R3N_GROWS, 0, box_rows - R3N_GROWS);
  const float v = __ldg(box + row * R3N_LANES + (mode == 2 ? 127 : 126));
  const int g = mode == 2 ? (int)__float_as_uint(v) : (int)v;
  return clampi(g, 0, geom_cols / R3N_LANES - 1);
}

// P-r3w k_vpu (scripts/tpu_session_r3w.py:86-99): `reps` runs of 32
// steps of six dependent operations on x, with c0 = b[0, k] and c1 = b[1,
// k] of the (rows, 8) table b. The reference reads k up to 31 on its 8
// columns; JAX's interpret mode clamps such an index to column 7, and so
// does this (ROADMAP Queue 3 (g)): steps 7-31 all take column 7. The 16
// constants are read once, before the reps, so that no load sits on the
// chain; each product and sum is rounded on its own, as the plain
// version's torch operations round it, and each min and max is one
// instruction: a step is 14 dependent operations.
__device__ __forceinline__ float vpu_chain(float x, const float* b,
                                           int reps) {
  float c0[R3W_K], c1[R3W_K];
  R3W_UNROLL
  for (int k = 0; k < R3W_K; ++k) {
    c0[k] = __ldg(b + k);
    c1[k] = __ldg(b + R3W_K + k);
  }
  for (int r = 0; r < reps; ++r) {
    R3W_UNROLL
    for (int k = 0; k < R3W_STEPS; ++k) {
      const int kc = k < R3W_K - 1 ? k : R3W_K - 1;
      const float a = c0[kc], c = c1[kc];
      x = add_rn(mul_rn(x, a), c);
      x = min_nan(add_rn(mul_rn(x, c), a), x);
      x = add_rn(mul_rn(x, a), c);
      x = max_nan(x, mul_rn(x, c));
      x = add_rn(mul_rn(x, a), c);
      x = min_nan(x, add_rn(mul_rn(x, c), a));
    }
  }
  return x;
}

// ---- P-r3w's products: where each value sits -------------------------
// Thread `tid` of a warpgroup (or lane `tid` of a warp for mma.sync):
// warp w = tid / 32, lane = tid % 32, grp = lane / 4, t = lane % 4 (PTX
// ISA, the register fragments of wgmma and of mma.m16n8k8).

// wgmma A in registers, TF32, 64 x 8: register i holds (row, k)
__device__ __forceinline__ void wg_a_tf32(int tid, int i, int& row, int& k) {
  const int lane = tid & 31;
  row = 16 * (tid >> 5) + (lane >> 2) + 8 * (i & 1);
  k = (lane & 3) + 4 * (i >> 1);
}

// wgmma D, float32, 64 x N: register i holds (row, col)
__device__ __forceinline__ void wg_d(int tid, int i, int& row, int& col) {
  const int lane = tid & 31;
  row = 16 * (tid >> 5) + (lane >> 2) + 8 * ((i >> 1) & 1);
  col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// wgmma B in shared memory, TF32, 8 x N, K-major without swizzle: the
// byte offset of (k, col); 32 bytes of k per column
__device__ __forceinline__ int wg_b_offset(int k, int col) {
  return (col >> 3) * R3W_SBO + (k >> 2) * R3W_LBO + (col & 7) * 16
         + (k & 3) * 4;
}

// mma.sync m16n8k8 bf16, lane `lane` of a warp: half h (0 low) of A (16 x
// 8) register i < 2 holds (row, k); half h of B's (8 x 8) one register
// holds (k, col); D register i < 4 holds (row, col)
__device__ __forceinline__ void mma_a_bf16(int lane, int i, int h, int& row,
                                           int& k) {
  row = (lane >> 2) + 8 * i;
  k = 2 * (lane & 3) + h;
}
__device__ __forceinline__ void mma_b_bf16(int lane, int h, int& k,
                                           int& col) {
  k = 2 * (lane & 3) + h;
  col = lane >> 2;
}
__device__ __forceinline__ void mma_d(int lane, int i, int& row, int& col) {
  row = (lane >> 2) + 8 * (i >> 1);
  col = 2 * (lane & 3) + (i & 1);
}
