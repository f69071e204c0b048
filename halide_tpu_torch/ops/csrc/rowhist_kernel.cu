// The row-histogram kernel (K3) of the port: counts[r, k] = #{p : lin[r, p]
// == k} for an (R, P) int32 array, written as f32 times a constant g; bins
// outside [0, K) drop (ops/rowhist_kernel.py wraps it).
//
// It replaces halide_tpu/ops/onehot_mxu.py:rowhist_blockdiag, whose TPU body
// builds one-hot operands in VMEM and counts with block-diagonal MXU
// products. Here a block takes kRows rows and keeps kRows * K int32 counters
// in shared memory (K = 256: 8 KB); its threads stride over P and count with
// shared-memory atomicAdd. Integer atomics commute, so the counts are exact
// and the same on every run; the f32 output is exact while the counts stay
// below 2^24.
//
// Bound: device-memory bytes (lin read once, the counts written once). The
// wrapper passes lin's strides; the fast thread index walks the axis along
// which neighbouring elements are neighbours in memory (the pixels of a row,
// or with rows_fast the rows themselves), so that a warp reads whole 32-byte
// sectors.
//
// The phases are __host__ __device__; without nvcc the file builds with a
// host C++ compiler into the same entry point, running the blocks' threads
// one after another (the CPU tests compare that build with the plain
// version).
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#define __host__
#define __device__
#define __global__
#endif

typedef long long i64;

constexpr int kRows = 8;                       // rows per block
constexpr int kThreads = 256;
constexpr int kPerRow = kThreads / kRows;      // threads on one row

struct RowhistArgs {
  const int32_t* lin;
  i64 srow, sp;
  int R, P, K;
  float g;
  float* out;           // (R, K), contiguous
  int rows_fast;
};

__host__ __device__ inline void rowhist_count(const RowhistArgs& p, int blk,
                                              int t, int* cnt) {
  const int lr = p.rows_fast ? t % kRows : t / kPerRow;
  const int pi = p.rows_fast ? t / kRows : t % kPerRow;
  const i64 r = (i64)blk * kRows + lr;
  if (r >= p.R) return;
  const int32_t* row = p.lin + r * p.srow;
  for (i64 q = pi; q < p.P; q += kPerRow) {
    const int v = row[q * p.sp];
    if (v >= 0 && v < p.K) {
#ifdef __CUDA_ARCH__
      atomicAdd(&cnt[lr * p.K + v], 1);
#else
      cnt[lr * p.K + v] += 1;
#endif
    }
  }
}

__host__ __device__ inline void rowhist_write(const RowhistArgs& p, int blk,
                                              int t, const int* cnt) {
  for (int i = t; i < kRows * p.K; i += kThreads) {
    const i64 r = (i64)blk * kRows + i / p.K;
    if (r < p.R) p.out[r * p.K + i % p.K] = (float)cnt[i] * p.g;
  }
}

#ifdef __CUDACC__
__global__ void rowhist_blocks(RowhistArgs p) {
  extern __shared__ int cnt[];
  for (int i = threadIdx.x; i < kRows * p.K; i += kThreads) cnt[i] = 0;
  __syncthreads();
  rowhist_count(p, blockIdx.x, threadIdx.x, cnt);
  __syncthreads();
  rowhist_write(p, blockIdx.x, threadIdx.x, cnt);
}
#endif

extern "C" int rowhist(const int32_t* lin, i64 srow, i64 sp, int R, int P,
                       int K, float g, float* out, int rows_fast,
                       void* stream) {
  RowhistArgs p{lin, srow, sp, R, P, K, g, out, rows_fast};
  const int blocks = (R + kRows - 1) / kRows;
  if (blocks == 0 || K == 0) return 0;
#ifdef __CUDACC__
  const size_t smem = (size_t)kRows * K * sizeof(int);
  rowhist_blocks<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
#else
  (void)stream;
  int* cnt = new int[(size_t)kRows * K];
  for (int blk = 0; blk < blocks; ++blk) {
    for (int i = 0; i < kRows * K; ++i) cnt[i] = 0;
    for (int t = 0; t < kThreads; ++t) rowhist_count(p, blk, t, cnt);
    for (int t = 0; t < kThreads; ++t) rowhist_write(p, blk, t, cnt);
  }
  delete[] cnt;
  return 0;
#endif
}
