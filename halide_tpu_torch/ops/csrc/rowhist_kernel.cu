// The row-histogram kernel (K3) of the port: counts[r, k] = #{p : lin[r, p]
// == k} for an (R, P) int32 array, written as f32 times a constant g; bins
// outside [0, K) drop (ops/rowhist_kernel.py wraps it and plans it).
//
// It replaces halide_tpu/ops/onehot_mxu.py:103 rowhist_blockdiag (its
// pl.pallas_call at :200), whose TPU body builds hi/lo one-hot operands in
// VMEM and counts with block-diagonal MXU products. What that body keeps out
// of device memory, the one-hots, this one keeps out too: the counters live
// in shared memory, and device traffic is the bins read once and the counts
// written once.
//
// Bound: device-memory bytes. What the design does about that:
// - Bytes in flight. A lane loads its items in the widest unit W (1, 2 or 4
//   int32: 4, 8 or 16 bytes) that the layout's strides allow, and issues L
//   loads before its first counter update, the first L before the block
//   zeroes its counters. The loads are evict-first (__ldcs): each bin
//   is read once, and the lines it brings into L2 go before others (dirty
//   ones, which would cost a write-back). In the row layout an item is W
//   neighbouring bins of one row; the head before the first aligned unit
//   and the tail after the last are counted element by element. With
//   rows_fast (neighbouring rows adjacent in memory) an item is one pixel of
//   W neighbouring rows. A build holds the kernels of the rule's 8 values in
//   flight a lane, (W, L) = (4, 2), (2, 4) and (1, 8), the last also the
//   first design's geometry's; ROWHIST_ALL_INFLIGHT builds L = 1, 2, 4 and
//   8 at every W (tools/k3_sweep.py). Up to 8 values in flight a lane the
//   kernel keeps to 32 registers (2048 threads an SM; (4, 2) spills 20
//   bytes there, and measured slower at the 48 registers it takes
//   uncapped), beyond that to 64.
// - A grid that fills the card. A block takes `rb` rows and `nt` threads
//   (plan fields); in the row layout a row's team is nt / rb threads, whole
//   warps. Where there are too few rows to fill the card, each row's items
//   are split over the `cl` blocks of a thread-block cluster: each counts
//   into its own shared memory, then after a cluster barrier each sums its
//   share of the (row, bin) counters over the cluster's blocks through
//   distributed shared memory, in rank order, and writes them scaled. One
//   launch, no scratch buffer, no global atomics.
// - Contention. Each row has `c` copies of its K counters; a warp counts
//   into copy (its warp index) % c, and the copies are summed in order
//   before the write. On the H100 a warp's atomics on one counter (a flat
//   image region) measured no slower than on spread ones, so the plan rule
//   takes one copy, and a lane counts each element with one atomicAdd
//   (tools/k3_sweep.py also times warp aggregation by __match_any_sync,
//   which lost).
// ROWHIST_PART builds the same kernels with parts compiled out, for timing
// them: 1 counting (the loads kept by an xor that is stored only if it takes
// one value), 2 the loads too (launch, zeroing, merge and write alone).
// Integer counts are exact whatever the order of the atomics; the f32
// output is exact while the counts stay below 2^24.
//
// The phases are __host__ __device__; without nvcc the file builds with a
// host C++ compiler into the same entry point, which runs each cluster's
// blocks one after another, each block lane by lane, and then the cluster's
// merge (the CPU tests compare that build with the plain version at every
// plan field).
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
#else
#include <vector>
#define __host__
#define __device__
#define __global__
#endif

typedef long long i64;

#ifndef ROWHIST_PART
#define ROWHIST_PART 0
#endif

constexpr int kSmemLimit = 227 * 1024;        // what one block can take

struct RowhistArgs {
  const int32_t* lin;
  i64 srow, sp;
  int R, P, K;
  float g;
  float* out;           // (R, K), contiguous
  int rows_fast;        // srow == 1: an item is one pixel of W rows
  int head;             // row layout: elements before the first aligned unit
  int rb, nt, c, cl;    // plan: rows a block, threads, copies, cluster size
};

// What one lane walks: its items at ptr, ptr + step, ..., the first n of
// them. Few fields: the loop keeps them in registers beside its L * W
// loaded values.
struct Lane {
  const int32_t* ptr;
  i64 step;
  int n;
  int key0, key_step;   // counter of element e: key0 + e * key_step + bin
  int nvalid;           // elements of an item inside [0, R) (rows_fast edge)
};

// Items of [first, end) taken every `every` from `first`.
__host__ __device__ inline int rowhist_count_of(int first, int end,
                                                int every) {
  return first < end ? (end - first + every - 1) / every : 0;
}

__host__ __device__ inline int rowhist_items(const RowhistArgs& p, int w) {
  if (p.rows_fast) return p.P;
  const int h = p.head < p.P ? p.head : p.P;
  return (p.P - h) / w;
}

// Cluster rank q's share [*lo, *hi) of n: whole shares of cdiv(n, cl).
__host__ __device__ inline void rowhist_share(int n, int q, int cl, int* lo,
                                              int* hi) {
  if (cl == 1) {
    *lo = 0;
    *hi = n;
    return;
  }
  const int share = (n + cl - 1) / cl;
  *lo = q * share < n ? q * share : n;
  *hi = *lo + share < n ? *lo + share : n;
}

template <int W>
__host__ __device__ inline Lane rowhist_lane(const RowhistArgs& p, int blk,
                                             int q, int t) {
  Lane ln;
  int q0, q1;
  rowhist_share(rowhist_items(p, W), q, p.cl, &q0, &q1);
  if (!p.rows_fast) {
    const int tpr = p.nt / p.rb;                 // a row's team, whole warps
    const int lr = t / tpr, i = t % tpr;
    const i64 r = (i64)blk * p.rb + lr;
    const int h = p.head < p.P ? p.head : p.P;
    const int end = r < p.R ? q1 : 0;
    ln.n = rowhist_count_of(q0 + i, end, tpr);
    ln.ptr = p.lin + r * p.srow + ((i64)h + (i64)(q0 + i) * W) * p.sp;
    ln.step = (i64)tpr * W * p.sp;
    ln.key0 = (lr * p.c + (i / 32) % p.c) * p.K;
    ln.key_step = 0;
    ln.nvalid = W;
  } else {
    const int g = p.rb / W;                      // lanes across a pixel's rows
    const int gi = t % g, pi = t / g;
    const i64 r = (i64)blk * p.rb + gi * W;
    const int every = p.nt / g;
    ln.n = rowhist_count_of(q0 + pi, q1, every);
    ln.ptr = p.lin + (i64)(q0 + pi) * p.sp + r;
    ln.step = (i64)every * p.sp;
    ln.key0 = (gi * W * p.c + (t / 32) % p.c) * p.K;
    ln.key_step = p.c * p.K;
    const i64 left = p.R - r;
    ln.nvalid = left <= 0 ? 0 : left < W ? (int)left : W;
  }
  if (ROWHIST_PART == 2) ln.n = 0;
  return ln;
}

__host__ __device__ inline void rowhist_add(int* cnt, int key, int n) {
#ifdef __CUDA_ARCH__
  atomicAdd(&cnt[key], n);
#else
  cnt[key] += n;
#endif
}

// The lane's k-th item -> its W counters (-1 where the element is outside
// the lane's range or R, or its bin outside [0, K)).
template <int W>
__host__ __device__ inline void rowhist_load(const RowhistArgs& p,
                                             const Lane& ln, int k,
                                             int* key) {
  const int32_t* src = ln.ptr + (i64)k * ln.step;
  int v[W];
  if (k < ln.n && ln.nvalid == W) {
#ifdef __CUDA_ARCH__
    if constexpr (W == 4) {
      const int4 x = __ldcs(reinterpret_cast<const int4*>(src));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else if constexpr (W == 2) {
      const int2 x = __ldcs(reinterpret_cast<const int2*>(src));
      v[0] = x.x; v[1] = x.y;
    } else {
      v[0] = __ldcs(src);
    }
#else
    memcpy(v, src, sizeof v);
#endif
  } else {
    for (int e = 0; e < W; ++e)
      v[e] = k < ln.n && e < ln.nvalid ? src[e] : -1;
  }
#pragma unroll
  for (int e = 0; e < W; ++e)
    key[e] = (unsigned)v[e] < (unsigned)p.K
        ? ln.key0 + e * ln.key_step + v[e] : -1;
}

// Row layout: the head and tail of each row that the unit does not cover,
// element by element (cluster rank 0 only).
template <int W>
__host__ __device__ inline void rowhist_edges(const RowhistArgs& p, int blk,
                                              int q, int t, int* cnt) {
  if (p.rows_fast || W == 1 || q != 0) return;
  const int tpr = p.nt / p.rb;
  const int lr = t / tpr, i = t % tpr;
  const i64 r = (i64)blk * p.rb + lr;
  if (r >= p.R) return;
  const int h = p.head < p.P ? p.head : p.P;
  const int tail0 = h + rowhist_items(p, W) * W;
  const int* row = p.lin + r * p.srow;
  const int key0 = (lr * p.c + (i / 32) % p.c) * p.K;
  if (i < h && (unsigned)row[i] < (unsigned)p.K)
    rowhist_add(cnt, key0 + row[i], 1);
  if (tail0 + i < p.P && (unsigned)row[tail0 + i] < (unsigned)p.K)
    rowhist_add(cnt, key0 + row[tail0 + i], 1);
}

// The counters of cluster rank s: on the card through distributed shared
// memory (the block's own where there is no cluster); on the host the ranks'
// arrays lie n ints apart.
__host__ __device__ inline const int* rowhist_rank(const RowhistArgs& p,
                                                  int* cnt, int s, int n) {
#ifdef __CUDA_ARCH__
  (void)n;
  return p.cl > 1 ? cg::this_cluster().map_shared_rank(cnt, s) : cnt;
#else
  return cnt + (size_t)s * n;
#endif
}

// Rank q of the cluster sums its share of the block's rb * K (row, bin)
// counters over the cluster's blocks (rank order) and their copies, and
// writes them times g.
__host__ __device__ inline void rowhist_merge(const RowhistArgs& p, int blk,
                                              int q, int t, int* cnt) {
  const int n = p.rb * p.K, ncnt = n * p.c;
  int lo, hi;
  rowhist_share(n, q, p.cl, &lo, &hi);
  for (int i = lo + t; i < hi; i += p.nt) {
    const int lr = p.rb == 1 ? 0 : i / p.K, k = p.rb == 1 ? i : i % p.K;
    const i64 r = (i64)blk * p.rb + lr;
    if (r >= p.R) continue;
    int sum = 0;
    for (int s = 0; s < p.cl; ++s) {
      const int* src = rowhist_rank(p, cnt, s, ncnt) + lr * p.c * p.K + k;
      for (int cp = 0; cp < p.c; ++cp) sum += src[cp * p.K];
    }
    p.out[r * p.K + k] = (float)sum * p.g;
  }
}

#ifdef __CUDACC__
// Counts one batch of a lane's counters (-1: none) into the block's.
template <int W, int L>
__device__ inline void rowhist_count_batch(const int (&key)[L][W], int* cnt,
                                           int& sink) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const int kk = key[j][e];
      if (ROWHIST_PART == 0) {
        if (kk >= 0) atomicAdd(&cnt[kk], 1);
      } else {
        sink ^= kk;
      }
    }
  }
}

template <int W, int L>
__global__ void __launch_bounds__(1024, W * L <= 8 ? 2 : 1)
rowhist_blocks(RowhistArgs p) {
  extern __shared__ int cnt[];
  const int t = threadIdx.x;
  const int q = p.cl > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int blk = blockIdx.x / p.cl;
  const Lane ln = rowhist_lane<W>(p, blk, q, t);
  // the first batch's loads go out before the counters are zeroed
  int key[L][W];
#pragma unroll
  for (int j = 0; j < L; ++j) rowhist_load<W>(p, ln, j, key[j]);
  for (int i = t; i < p.rb * p.c * p.K; i += p.nt) cnt[i] = 0;
  __syncthreads();
  if (ROWHIST_PART != 2) rowhist_edges<W>(p, blk, q, t, cnt);
  int sink = 0;
  for (int k = 0;;) {
    rowhist_count_batch<W, L>(key, cnt, sink);
    k += L;
    if (k >= ln.n) break;
#pragma unroll
    for (int j = 0; j < L; ++j) rowhist_load<W>(p, ln, k + j, key[j]);
  }
  if (ROWHIST_PART == 1 && sink == 0x7fffffff) cnt[0] = sink;
  if (p.cl > 1) {
    cg::this_cluster().sync();
    rowhist_merge(p, blk, q, t, cnt);
    cg::this_cluster().sync();   // no block leaves while another reads it
  } else {
    __syncthreads();
    rowhist_merge(p, blk, q, t, cnt);
  }
}

// Once per kernel: all of the SM's unified memory to shared memory, and
// dynamic shared memory up to the 227 KB a block can take.
template <int W, int L>
static cudaError_t rowhist_attributes() {
  static const cudaError_t attr = [] {
    auto kern = rowhist_blocks<W, L>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    return e;
  }();
  return attr;
}

template <int W, int L>
static int rowhist_run(const RowhistArgs& p, void* stream) {
  const cudaError_t attr = rowhist_attributes<W, L>();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((p.R + p.rb - 1) / p.rb * p.cl));
  cfg.blockDim = dim3((unsigned)p.nt);
  cfg.dynamicSmemBytes = (size_t)p.rb * p.c * p.K * sizeof(int);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)p.cl;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = p.cl > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, rowhist_blocks<W, L>, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int W, int L>
static int rowhist_resident_of(int nt, int smem) {
  const cudaError_t attr = rowhist_attributes<W, L>();
  if (attr != cudaSuccess) return -(int)attr;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, rowhist_blocks<W, L>, nt, (size_t)smem);
  return e == cudaSuccess ? n : -(int)e;
}
#else
template <int W, int L>
static int rowhist_run(const RowhistArgs& p, void* stream) {
  (void)stream;
  const int n = p.rb * p.c * p.K, blocks = (p.R + p.rb - 1) / p.rb;
  std::vector<int> cnt((size_t)n * p.cl);
  for (int blk = 0; blk < blocks; ++blk) {
    for (int& x : cnt) x = 0;
    for (int q = 0; q < p.cl; ++q) {
      int* c = &cnt[(size_t)q * n];
      for (int t = 0; t < p.nt; ++t) {
        if (ROWHIST_PART != 2) rowhist_edges<W>(p, blk, q, t, c);
        const Lane ln = rowhist_lane<W>(p, blk, q, t);
        for (int k = 0; k < ln.n && ROWHIST_PART == 0; k += L) {
          int key[L][W];
          for (int j = 0; j < L; ++j) rowhist_load<W>(p, ln, k + j, key[j]);
          for (int j = 0; j < L; ++j)
            for (int e = 0; e < W; ++e)
              if (key[j][e] >= 0) c[key[j][e]] += 1;
        }
      }
    }
    for (int q = 0; q < p.cl; ++q)
      for (int t = 0; t < p.nt; ++t) rowhist_merge(p, blk, q, t, cnt.data());
  }
  return 0;
}

template <int W, int L>
static int rowhist_resident_of(int nt, int smem) {
  // the card's limits: 2048 threads (1024 at the 64 registers of more than
  // 8 values in flight), 32 blocks and 228 KB of shared memory an SM (1 KB
  // of it per block)
  int n = (W * L <= 8 ? 2048 : 1024) / nt;
  const int by_smem = 228 * 1024 / (smem + 1024);
  n = by_smem < n ? by_smem : n;
  return n < 32 ? n : 32;
}
#endif

typedef int (*RunFn)(const RowhistArgs&, void*);
typedef int (*ResidentFn)(int, int);

// The (W, L) kernels of a build (see the notes at the top).
#ifdef ROWHIST_ALL_INFLIGHT
#define ROWHIST_KERNELS(X) X(1, 1) X(1, 2) X(1, 4) X(1, 8) X(2, 1) X(2, 2) \
  X(2, 4) X(2, 8) X(4, 1) X(4, 2) X(4, 4) X(4, 8)
#else
#define ROWHIST_KERNELS(X) X(4, 2) X(2, 4) X(1, 8)
#endif

static int rowhist_pick(int unit, int L, RunFn* run, ResidentFn* res) {
#define ROWHIST_PICK(W_, L_)              \
  if (unit == 4 * (W_) && L == (L_)) {    \
    *run = rowhist_run<W_, L_>;           \
    *res = rowhist_resident_of<W_, L_>;   \
    return 0;                             \
  }
  ROWHIST_KERNELS(ROWHIST_PICK)
#undef ROWHIST_PICK
  return -1;
}

// 1 where this build holds the kernel of a load unit (bytes) and loads in
// flight a lane, else 0.
extern "C" int rowhist_has(int unit, int inflight) {
  RunFn run;
  ResidentFn res;
  return rowhist_pick(unit, inflight, &run, &res) == 0;
}

// Blocks of one plan's kernel that fit an SM at once (on the card, CUDA's
// occupancy calculator on the build; on the host, the card's limits); -1
// where the build holds no such kernel.
extern "C" int rowhist_resident(int unit, int inflight, int threads,
                                int smem_bytes) {
  RunFn run;
  ResidentFn res;
  if (rowhist_pick(unit, inflight, &run, &res) != 0) return -1;
  return res(threads, smem_bytes);
}

// The entry point. The plan (rows .. cluster) comes checked from the
// wrapper; -1 where it names no kernel of this build.
extern "C" int rowhist(const int32_t* lin, i64 srow, i64 sp, int R, int P,
                       int K, float g, float* out, int rows_fast, int head,
                       int rows, int threads, int unit, int inflight,
                       int copies, int cluster, void* stream) {
  RunFn run;
  ResidentFn res;
  if (rowhist_pick(unit, inflight, &run, &res) != 0) return -1;
  if (R == 0 || K == 0) return 0;
  RowhistArgs p{lin, srow, sp, R, P, K, g, out, rows_fast, head,
                rows, threads, copies, cluster};
  return run(p, stream);
}
