// The scan kernel (K2) of the port: y[i] = a * y[i-1] + b[i] along one axis
// of an f32 array, forward or backward, from an init row (ops/scan_kernel.py
// wraps it).
//
// It replaces halide_tpu/ops/pallas_scan.py:linear_scan, both of its Pallas
// bodies: `_kernel_const` (a scalar coefficient, entry point scan_const) and
// `_kernel_general` (a per-element coefficient, entry point scan_general).
//
// Layout: the array is viewed as (G, N, M) with N the scan axis, through the
// strides the wrapper passes (no transpose). One thread owns one (g, m) line
// and walks n with the carry in a register. The TPU kernel carried through
// VMEM scratch across grid steps that run in order; CUDA blocks run in no set
// order, so the carry stays inside one thread. A backward scan walks from
// the end of the line (no padding). Loads come in chunks of C elements, all
// issued before the chunk's recurrence runs, so that C loads of a line are
// in flight at once.
//
// Bound: device-memory bytes (b read, y written, and a read for
// scan_general). Known limits: where the scan axis is the contiguous one
// (M == 1), the threads of a warp read 32 different lines (uncoalesced);
// where it is not, there are only G * M threads, one line each.
//
// The line body is __host__ __device__; without nvcc the file builds with a
// host C++ compiler into the same entry points, running every line on the
// host (the CPU tests compare that build with the plain version).
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

struct ScanArgs {
  const float* a;       // per-element coefficients, or null (scan_const)
  i64 asg, asn, asm_;
  float a_const;
  const float* b;
  i64 bsg, bsn, bsm;
  const float* init;    // y before the first step in scan order: (G, 1, M)
  i64 isg, ism;
  float* y;
  i64 ysg, ysn, ysm;
  int G, N, M, backward;
};

template <bool kConst, int C>
__host__ __device__ inline void scan_one(const ScanArgs& p, i64 line) {
  const i64 g = line / p.M, m = line % p.M;
  const float* b = p.b + g * p.bsg + m * p.bsm;
  const float* a = kConst ? nullptr : p.a + g * p.asg + m * p.asm_;
  float* y = p.y + g * p.ysg + m * p.ysm;
  float carry = p.init[g * p.isg + m * p.ism];
  for (int base = 0; base < p.N; base += C) {
    float bv[C];
    float av[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int i = base + j;
      if (i < p.N) {
        const i64 n = p.backward ? (i64)(p.N - 1 - i) : (i64)i;
        bv[j] = b[n * p.bsn];
        if constexpr (!kConst) av[j] = a[n * p.asn];
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int i = base + j;
      if (i < p.N) {
        const i64 n = p.backward ? (i64)(p.N - 1 - i) : (i64)i;
        float coef;
        if constexpr (kConst) {
          coef = p.a_const;
        } else {
          coef = av[j];
        }
        carry = coef * carry + bv[j];
        y[n * p.ysn] = carry;
      }
    }
  }
}

constexpr int kConstChunk = 32;
constexpr int kGeneralChunk = 16;

#ifdef __CUDACC__
constexpr int kThreads = 64;

template <bool kConst, int C>
__global__ void scan_lines(ScanArgs p) {
  const i64 line = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (line < (i64)p.G * p.M) scan_one<kConst, C>(p, line);
}

static int run(const ScanArgs& p, void* stream) {
  const i64 lines = (i64)p.G * p.M;
  if (lines == 0 || p.N == 0) return 0;
  const unsigned blocks = (unsigned)((lines + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (p.a == nullptr) {
    scan_lines<true, kConstChunk><<<blocks, kThreads, 0, s>>>(p);
  } else {
    scan_lines<false, kGeneralChunk><<<blocks, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
#else
static int run(const ScanArgs& p, void*) {
  const i64 lines = (i64)p.G * p.M;
  for (i64 line = 0; line < lines; ++line) {
    if (p.a == nullptr) {
      scan_one<true, kConstChunk>(p, line);
    } else {
      scan_one<false, kGeneralChunk>(p, line);
    }
  }
  return 0;
}
#endif

extern "C" int scan_const(const float* b, i64 bsg, i64 bsn, i64 bsm,
                          float a, const float* init, i64 isg, i64 ism,
                          float* y, i64 ysg, i64 ysn, i64 ysm, int G, int N,
                          int M, int backward, void* stream) {
  ScanArgs p{nullptr, 0, 0, 0, a, b, bsg, bsn, bsm, init, isg, ism,
             y, ysg, ysn, ysm, G, N, M, backward};
  return run(p, stream);
}

extern "C" int scan_general(const float* a, i64 asg, i64 asn, i64 asm_,
                            const float* b, i64 bsg, i64 bsn, i64 bsm,
                            const float* init, i64 isg, i64 ism, float* y,
                            i64 ysg, i64 ysn, i64 ysm, int G, int N, int M,
                            int backward, void* stream) {
  ScanArgs p{a, asg, asn, asm_, 0.0f, b, bsg, bsn, bsm, init, isg, ism,
             y, ysg, ysn, ysm, G, N, M, backward};
  return run(p, stream);
}
