// Per-thread parts of the probe kernels of csrc/probes.cu, plain C++
// apart from the CUDA qualifiers, so that tests/test_torch_probes.py
// compiles them with g++ and holds them to rene_tpu_torch/ops/probes.py.
#pragma once
#include <stdint.h>

#include "math.cuh"

#define R3N_GROWS 2    // box rows per group (tpu_session_r3n.py `grows`)
#define R3N_LANES 128  // columns of a box row and of a geom block
#define R3N_ROWS 8     // geom rows, the (8, 128) output
#define R3W_STEPS 32   // unrolled steps of k_vpu's body
#define R3W_K 8        // columns of the (M, 8) table b

// jnp.minimum: a NaN input wins (fminf would drop it)
__device__ __forceinline__ float minn(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

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
// does this (ROADMAP Queue 3 (g)). Each product and sum rounded on its
// own, as the plain version's torch operations.
__device__ __forceinline__ float vpu_chain(float x, const float* b,
                                           int reps) {
  for (int r = 0; r < reps; ++r) {
    for (int k = 0; k < R3W_STEPS; ++k) {
      const int kc = k < R3W_K - 1 ? k : R3W_K - 1;
      const float c0 = __ldg(b + kc), c1 = __ldg(b + R3W_K + kc);
      x = add_rn(mul_rn(x, c0), c1);
      x = minn(add_rn(mul_rn(x, c1), c0), x);
      x = add_rn(mul_rn(x, c0), c1);
      x = maxn(x, mul_rn(x, c1));
      x = add_rn(mul_rn(x, c0), c1);
      x = minn(x, add_rn(mul_rn(x, c1), c0));
    }
  }
  return x;
}
