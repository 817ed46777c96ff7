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
// offsets from traced scalars) is an indexed load here: one block of 256
// threads, each reading the index (one broadcast load for its warp) and
// moving one 16-byte word. Bound: a launch, not bytes (floor_probe's
// empty launch is its floor).
//
// P-r3w replaces scripts/tpu_session_r3w.py `k_mxu_hi` :67, `k_mxu_def`
// :77 and `k_vpu` :86 (timed at :46): a (384, 8) @ (8, 1024) float32
// product on the matrix unit against a chain of scalar multiply-adds,
// `reps` times inside the kernel, each rep's operand taking the previous
// rep's result times 0 (the probe's `acc[0, 0] * 0.0`), so that no rep is
// hoisted. Its question on this card: do the tensor cores beat the CUDA
// cores at a triangle side test, a product of depth 8? What bounds every
// kind is the chain of dependent reps (latency), not the tensor cores'
// rate: floor_kernel below measures the links of that chain.
//   hi:  3xTF32 (hi*hi + hi*lo + lo*hi of a TF32 split): float32
//        accuracy, HIGHEST's counterpart;
//   def: one bf16 pass, float32 accumulation: the TPU's default precision
//        for float32;
//   vpu: 1024 threads, each the 32-step chain of probes.cuh vpu_chain on
//        the CUDA cores.
// The products' designs (PERF.md section 6 has the race that chose them
// and the readings of the designs that lost it):
//   hi on wgmma (mxu_wg_kernel): the product transposed, out^T (n x m) =
//        (r + dep)^T (n x 8) b^T (8 x m): the operand that carries a rep's
//        dependency is A, in registers; b^T's TF32 split is written to
//        shared memory once per launch in the layout its descriptor names;
//        one warpgroup takes 64 rays and R3W_WG_ROWS rows of b, and runs
//        the three passes as one group with one wait per rep;
//   def on mma.sync (mxu_mma_kernel): one warp per R3W_MMA_TILES 16 x 8
//        tiles, each its own chain, so that a scheduler has HMMAs to issue
//        while each waits; m16n8k8 bf16, no zero pad.
// Each writes its last rep: the whole (384, 1024) product (the TPU probe
// kept its first 8 rows), or the (8, 128) chain values.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "probes.cuh"

__global__ void __launch_bounds__(256)
rowslice_kernel(int mode, int si, const float* __restrict__ box,
                int box_rows, const float* __restrict__ geom, int geom_cols,
                float* __restrict__ out) {
  const int i = threadIdx.x;   // float4 i: row i / 32, columns 4 (i % 32)
  const int g = rowslice_group(mode, si, box, box_rows, geom, geom_cols);
  const float4* src = reinterpret_cast<const float4*>(
      geom + (i >> 5) * geom_cols + g * R3N_LANES);
  reinterpret_cast<float4*>(out)[i] = __ldg(src + (i & 31));
}

// x rounded to TF32 (to nearest, ties away from zero, as cvt.rna): two
// integer operations where cvt.rna.tf32.f32 takes a longer sequence on
// sm_90 (PERF.md section 6). Finite x only
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, hi a TF32 value; the tensor cores read lo's leading 19 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[2],
                                         uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// ---- wgmma ----------------------------------------------------------------
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous product
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
  R3W_UNROLL
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the descriptor of a K-major operand in shared memory without swizzle
// (probes.cuh wg_b_offset): address, LBO and SBO in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4)
         | (uint64_t)(R3W_LBO >> 4) << 16
         | (uint64_t)(R3W_SBO >> 4) << 32;
}

// d (64 x 24) = a (64 x 8, TF32, registers) b (8 x 24, TF32, shared
// memory at `desc`), plus d where scale_d is 1: one warpgroup. Issued
// only: wg_commit and wg_wait0 end it
__device__ __forceinline__ void wgmma_tf32(float (&d)[R3W_WG_ROWS / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  static_assert(R3W_WG_ROWS == 24, "the asm below is m64n24k8");
  asm volatile(
      "{.reg .pred p; setp.ne.b32 p, %17, 0; "
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1;}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// one rep of hi: d = (ra + dep) b in 3xTF32, dep = d[0] * 0 (the probe's
// dependency on the previous rep), lo*hi + hi*lo + hi*hi in one group
// with one wait. b's TF32 hi and lo parts are at desc_h and desc_l
__device__ __forceinline__ void wg_hi_rep(float (&d)[R3W_WG_ROWS / 2],
                                          const float (&ra)[4],
                                          uint64_t desc_h, uint64_t desc_l) {
  const float dep = d[0] * 0.0f;
  uint32_t ah[4], al[4];
  R3W_UNROLL
  for (int i = 0; i < 4; ++i) split_tf32(ra[i] + dep, ah[i], al[i]);
  reg_fence(d);
  wg_fence();
  wgmma_tf32(d, al, desc_h, 0);
  wgmma_tf32(d, ah, desc_l, 1);
  wgmma_tf32(d, ah, desc_h, 1);
  wg_commit();
  wg_wait0();
  reg_fence(d);
}

// out (m, n) = b (m, 8) @ r (8, n) in 3xTF32 as out^T = r^T b^T on wgmma:
// block (x, y) is one warpgroup over rays (columns of r) 64 x .. 64 x + 63
// and rows R3W_WG_ROWS y .. of b
__global__ void __launch_bounds__(128)
mxu_wg_kernel(const float* __restrict__ b, const float* __restrict__ r,
              int n, int reps, float* __restrict__ out) {
  constexpr int N = R3W_WG_ROWS;
  // b^T's tile, TF32 hi and lo; 32 bytes a column
  __shared__ __align__(128) uint32_t bsm[2][N * R3W_K];
  __shared__ float ot[N][64 + 4];   // the result, transposed
  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * 64, row0 = blockIdx.y * N;
  for (int e = tid; e < N * R3W_K; e += 128) {
    const int col = e / R3W_K, k = e % R3W_K;
    uint32_t h, l;
    split_tf32(__ldg(b + (size_t)(row0 + col) * R3W_K + k), h, l);
    const int w = wg_b_offset(k, col) / 4;
    bsm[0][w] = h;
    bsm[1][w] = l;
  }
  // the shared-memory writes, seen by the tensor cores' (async) reads
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const uint64_t desc_h = smem_desc(bsm[0]), desc_l = smem_desc(bsm[1]);
  // this thread's elements of r^T: A register i
  float ra[4];
  R3W_UNROLL
  for (int i = 0; i < 4; ++i) {
    int row, k;
    wg_a_tf32(tid, i, row, k);
    ra[i] = __ldg(r + (size_t)k * n + ray0 + row);
  }
  float d[N / 2];
  R3W_UNROLL
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  for (int rep = 0; rep < reps; ++rep) wg_hi_rep(d, ra, desc_h, desc_l);
  R3W_UNROLL
  for (int i = 0; i < N / 2; ++i) {
    int row, col;
    wg_d(tid, i, row, col);
    ot[col][row] = d[i];
  }
  __syncthreads();
  for (int e = tid; e < N * 64; e += 128)
    out[(size_t)(row0 + e / 64) * n + ray0 + e % 64] = ot[e / 64][e % 64];
}

// out (m, n) = b (m, 8) @ r (8, n) in one bf16 pass on mma.sync: one warp
// per R3W_MMA_TILES tiles of 16 x 8 along n, each its own chain of reps
__global__ void __launch_bounds__(128)
mxu_mma_kernel(const float* __restrict__ b, const float* __restrict__ r,
               int m, int n, int reps, float* __restrict__ out) {
  constexpr int T = R3W_MMA_TILES;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int tiles_n = n / (8 * T);
  if (warp >= (m / 16) * tiles_n) return;
  const int lane = threadIdx.x & 31;
  const int row0 = (warp / tiles_n) * 16, col0 = (warp % tiles_n) * 8 * T;
  uint32_t a16[2];
  R3W_UNROLL
  for (int i = 0; i < 2; ++i) {
    int row, k0, k1;
    mma_a_bf16(lane, i, 0, row, k0);
    mma_a_bf16(lane, i, 1, row, k1);
    a16[i] = pack_bf16(__ldg(b + (row0 + row) * R3W_K + k0),
                       __ldg(b + (row0 + row) * R3W_K + k1));
  }
  float rb[T][2];
  R3W_UNROLL
  for (int j = 0; j < T; ++j)
    R3W_UNROLL
    for (int h = 0; h < 2; ++h) {   // bf16 half h of B's register
      int k, col;
      mma_b_bf16(lane, h, k, col);
      rb[j][h] = __ldg(r + (size_t)k * n + col0 + 8 * j + col);
    }
  float d[T][4];
  R3W_UNROLL
  for (int j = 0; j < T; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
  for (int rep = 0; rep < reps; ++rep) {
    R3W_UNROLL
    for (int j = 0; j < T; ++j) {
      const float dep = d[j][0] * 0.0f;
      const float x0 = rb[j][0] + dep, x1 = rb[j][1] + dep;
      d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
      mma_bf16(d[j], a16, pack_bf16(x0, x1));
    }
  }
  R3W_UNROLL
  for (int j = 0; j < T; ++j)
    R3W_UNROLL
    for (int i = 0; i < 4; ++i) {
      int row, col;
      mma_d(lane, i, row, col);
      out[(size_t)(row0 + row) * n + col0 + 8 * j + col] = d[j][i];
    }
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
  rowslice_kernel<<<1, R3N_ROWS * R3N_LANES / 4, 0, (cudaStream_t)stream>>>(
      mode, si, box, box_rows, geom, geom_cols, out);
  return (int)cudaGetLastError();
}

// kind 0: hi, 1: def (out (m, n); the caller checks m % R3W_WG_ROWS and
// n % 64 for hi, m % 16 and n % (8 R3W_MMA_TILES) for def); 2: vpu (out
// (8, 128), n >= 1024)
extern "C" int mxu_probe_launch(int kind, const float* b, const float* r,
                                int m, int n, int reps, float* out,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0) {
    mxu_wg_kernel<<<dim3(n / 64, m / R3W_WG_ROWS), 128, 0, st>>>(b, r, n,
                                                                  reps, out);
  } else if (kind == 1) {
    const int warps = (m / 16) * (n / (8 * R3W_MMA_TILES));
    mxu_mma_kernel<<<(warps * 32 + 127) / 128, 128, 0, st>>>(b, r, m, n,
                                                             reps, out);
  } else {
    vpu_kernel<<<R3N_ROWS * R3N_LANES / 128, 128, 0, st>>>(b, r, reps, out);
  }
  return (int)cudaGetLastError();
}

// ---- chain floors ------------------------------------------------------
// Every probe is a chain of dependent reps, so the least time a launch
// can take is set by the latency of the operations on that chain, not by
// the rates of the guide's bound. The floor kernels time one link of such
// a chain, in SM cycles by clock64, for each operation the probes'
// critical paths hold (FLOOR_* below, rene_tpu_torch/probes.py
// FLOOR_KINDS): one block of one warpgroup, `iters` links, each on the
// previous link's result. The HMMA and wgmma links put the previous
// result's bits into an operand, as a probe's rep adds d * 0 to its
// operand.
#define FLOOR_FMUL 0
#define FLOOR_FADD 1
#define FLOOR_MINMAX 2       // min.NaN / max.NaN, in turns
#define FLOOR_CVT_BF16 3     // cvt.rn.bf16x2.f32
#define FLOOR_HMMA_BF16 4    // mma.sync m16n8k8 bf16, result into operand
#define FLOOR_WG_HI 5        // one rep of hi on wgmma (floor_wg_kernel)

template <int KIND>
__global__ void __launch_bounds__(128)
floor_kernel(int iters, float c, long long* __restrict__ cycles,
             float* __restrict__ sink) {
  float x = c * (float)threadIdx.x;
  float d[4] = {x, x, x, x};
  const uint32_t a[2] = {0x3f803f80u, 0x3f803f80u};   // (1.0, 1.0) in bf16
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; i += 8) {
    R3W_UNROLL
    for (int j = 0; j < 8; ++j) {
      if constexpr (KIND == FLOOR_FMUL) {
        x = __fmul_rn(x, c);
      } else if constexpr (KIND == FLOOR_FADD) {
        x = __fadd_rn(x, c);
      } else if constexpr (KIND == FLOOR_MINMAX) {
        x = (j & 1) ? max_nan(x, -c) : min_nan(x, c);
      } else if constexpr (KIND == FLOOR_CVT_BF16) {
        x = __uint_as_float(pack_bf16(x, c));
      } else {
        const uint32_t bf = __float_as_uint(d[0]);
        d[0] = d[1] = d[2] = d[3] = 0.f;
        mma_bf16(d, a, bf);
      }
    }
  }
  // the store waits for the chain's last link; the clock is read after it
  sink[threadIdx.x] = x + d[0];
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

// the wgmma link: one rep of mxu_wg_kernel, its code as there (wg_hi_rep:
// dep, the TF32 split and the three products in one group)
__global__ void __launch_bounds__(128)
floor_wg_kernel(int iters, float c, long long* __restrict__ cycles,
                float* __restrict__ sink) {
  __shared__ __align__(128) uint32_t bs[2][R3W_WG_ROWS * R3W_K];
  for (int i = threadIdx.x; i < R3W_WG_ROWS * R3W_K; i += 128)
    bs[0][i] = bs[1][i] = 0x3f800000u;   // 1.0 in TF32
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const uint64_t desc_h = smem_desc(bs[0]), desc_l = smem_desc(bs[1]);
  float d[R3W_WG_ROWS / 2];
  R3W_UNROLL
  for (int i = 0; i < R3W_WG_ROWS / 2; ++i) d[i] = 0.f;
  float ra[4];
  R3W_UNROLL
  for (int i = 0; i < 4; ++i) ra[i] = c * (float)(i + 1);
  const long long t0 = clock64();
  for (int i = 0; i < iters; i += 8) {
    R3W_UNROLL
    for (int j = 0; j < 8; ++j) wg_hi_rep(d, ra, desc_h, desc_l);
  }
  sink[threadIdx.x] = d[0];
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

__global__ void empty_kernel() {}

// cycles[0]: clock64 cycles of `iters` links (a multiple of 8) of floor
// chain `kind` (FLOOR_*); sink: 128 floats
extern "C" int floor_probe_launch(int kind, int iters, long long* cycles,
                                  float* sink, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float c = 1.0f + 1.0f / 1024.0f;
#define FLOOR_CASE(K)                                                    \
  case K:                                                                \
    floor_kernel<K><<<1, 128, 0, st>>>(iters, c, cycles, sink);         \
    break;
  switch (kind) {
    FLOOR_CASE(FLOOR_FMUL)
    FLOOR_CASE(FLOOR_FADD)
    FLOOR_CASE(FLOOR_MINMAX)
    FLOOR_CASE(FLOOR_CVT_BF16)
    FLOOR_CASE(FLOOR_HMMA_BF16)
    case FLOOR_WG_HI:
      floor_wg_kernel<<<1, 128, 0, st>>>(iters, c, cycles, sink);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLOOR_CASE
  return (int)cudaGetLastError();
}

// the least launch: one empty block, timed as the probes are
extern "C" int empty_probe_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
