// Probe kernels for NVIDIA Hopper (sm_90a): the counterparts of the last
// two Mosaic probes of the reference's TPU probe scripts. Plain versions:
// rene_tpu_torch/ops/probes.py; run on a card: python -m
// rene_tpu_torch.probes.
//
// P-r3n replaces scripts/tpu_session_r3n.py `k_p1` / `k_p2` / `k_p3`
// (:46-66, called at :72): an (8, 128) block of a geometry table picked by
// a group index read at run time from a row of a box table (a float cast
// to int, an int stored as float bits, or offset by an octant computed
// from the data). What Mosaic made a question (dynamic row and lane
// offsets from traced scalars) is an indexed load here; one thread per
// output element reads the index and copies. Bound: a launch, not bytes.
//
// P-r3w replaces scripts/tpu_session_r3w.py `k_mxu_hi` :67, `k_mxu_def`
// :77 and `k_vpu` :86 (timed at :46): a (384, 8) @ (8, 1024) float32
// product on the matrix unit against a chain of scalar multiply-adds,
// `reps` times inside the kernel. Its question on this card: do the
// tensor cores beat the CUDA cores at a triangle side test, a product of
// depth 8? On Hopper the product runs through `mma.sync`, one warp per 16
// x 8 output tile, each rep taking the previous rep's result times 0 into
// its operand (the probe's `acc[0, 0] * 0.0`), so that no rep is hoisted:
//   hi:  m16n8k8 TF32, three passes (hi*hi + hi*lo + lo*hi of a 3xTF32
//        split): float32 accuracy, HIGHEST's counterpart;
//   def: one m16n8k16 bf16 pass, K padded from 8 to 16 with zeros, float32
//        accumulation: the TPU's default precision for float32;
//   vpu: 1024 threads, each the 32-step chain of probes.cuh vpu_chain on
//        the CUDA cores.
// Each writes its last rep: the whole (384, 1024) product (the TPU probe
// kept its first 8 rows), or the (8, 128) chain values. What bounds them:
// the dependency between reps (latency), not the tensor cores' rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "probes.cuh"

__global__ void __launch_bounds__(128)
rowslice_kernel(int mode, int si, const float* __restrict__ box,
                int box_rows, const float* __restrict__ geom, int geom_cols,
                float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R3N_ROWS * R3N_LANES) return;
  const int g = rowslice_group(mode, si, box, box_rows, geom, geom_cols);
  out[i] = __ldg(geom + (i / R3N_LANES) * geom_cols + g * R3N_LANES
                 + i % R3N_LANES);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out (m, n) = b (m, 8) @ r (8, n), one warp per 16 x 8 tile. Fragments
// (PTX ISA, mma.m16n8k8 / m16n8k16): lane = 4 * grp + t; A holds rows
// grp and grp + 8, B column grp, D rows grp and grp + 8 at columns 2t
// and 2t + 1.
template <bool HI>
__global__ void __launch_bounds__(128)
mxu_kernel(const float* __restrict__ b, const float* __restrict__ r, int m,
           int n, int reps, float* __restrict__ out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int tiles_n = n / 8;
  if (warp >= (m / 16) * tiles_n) return;
  const int lane = threadIdx.x & 31, grp = lane >> 2, t = lane & 3;
  const int row = (warp / tiles_n) * 16 + grp;
  const int col = (warp % tiles_n) * 8;
  const float* b0 = b + row * R3W_K;
  const float* b8 = b + (row + 8) * R3W_K;
  // HI: k = t and t + 4 (TF32 A: rows grp, grp + 8; B: rows t, t + 4).
  // bf16: k = 2t and 2t + 1 (A columns and B rows 8-15 are the zero pad)
  const int k0 = HI ? t : 2 * t, k1 = HI ? t + 4 : 2 * t + 1;
  const float rb0 = __ldg(r + k0 * n + col + grp);
  const float rb1 = __ldg(r + k1 * n + col + grp);
  uint32_t ah[4], al[4];
  if (HI) {
    split_tf32(__ldg(b0 + k0), ah[0], al[0]);
    split_tf32(__ldg(b8 + k0), ah[1], al[1]);
    split_tf32(__ldg(b0 + k1), ah[2], al[2]);
    split_tf32(__ldg(b8 + k1), ah[3], al[3]);
  } else {
    ah[0] = pack_bf16(__ldg(b0 + k0), __ldg(b0 + k1));
    ah[1] = pack_bf16(__ldg(b8 + k0), __ldg(b8 + k1));
    ah[2] = ah[3] = 0u;
  }
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int rep = 0; rep < reps; ++rep) {
    const float dep = d[0] * 0.0f;
    const float x0 = rb0 + dep, x1 = rb1 + dep;
    d[0] = d[1] = d[2] = d[3] = 0.f;
    if (HI) {
      uint32_t bh[2], bl[2];
      split_tf32(x0, bh[0], bl[0]);
      split_tf32(x1, bh[1], bl[1]);
      mma_tf32(d, al, bh);
      mma_tf32(d, ah, bl);
      mma_tf32(d, ah, bh);
    } else {
      const uint32_t bb[2] = {pack_bf16(x0, x1), 0u};
      mma_bf16(d, ah, bb);
    }
  }
  float* o = out + (size_t)row * n + col + 2 * t;
  o[0] = d[0];
  o[1] = d[1];
  o[8 * n] = d[2];
  o[8 * n + 1] = d[3];
}

__global__ void __launch_bounds__(128)
vpu_kernel(const float* __restrict__ b, const float* __restrict__ r,
           int reps, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R3N_ROWS * R3N_LANES) return;
  // r8 * 0.0 + 1.0, r8 = r[0] as (8, 128)
  const float x = add_rn(mul_rn(__ldg(r + i), 0.0f), 1.0f);
  out[i] = vpu_chain(x, b, reps);
}

extern "C" int rowslice_probe_launch(int mode, int si, const float* box,
                                     int box_rows, const float* geom,
                                     int geom_cols, float* out,
                                     void* stream) {
  rowslice_kernel<<<R3N_ROWS * R3N_LANES / 128, 128, 0,
                    (cudaStream_t)stream>>>(mode, si, box, box_rows, geom,
                                            geom_cols, out);
  return (int)cudaGetLastError();
}

// kind 0: hi, 1: def (out (m, n)); 2: vpu (out (8, 128), n >= 1024)
extern "C" int mxu_probe_launch(int kind, const float* b, const float* r,
                                int m, int n, int reps, float* out,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = ((m / 16) * (n / 8) * 32 + 127) / 128;
  if (kind == 0)
    mxu_kernel<true><<<blocks, 128, 0, st>>>(b, r, m, n, reps, out);
  else if (kind == 1)
    mxu_kernel<false><<<blocks, 128, 0, st>>>(b, r, m, n, reps, out);
  else
    vpu_kernel<<<R3N_ROWS * R3N_LANES / 128, 128, 0, st>>>(b, r, reps, out);
  return (int)cudaGetLastError();
}
