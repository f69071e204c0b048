// The scan kernel (K2) of the port: y[i] = a * y[i-1] + b[i] along one axis
// of an f32 array, forward or backward, from an init row (ops/scan_kernel.py
// wraps it).
//
// It replaces halide_tpu/ops/pallas_scan.py:linear_scan, both of its Pallas
// bodies: `_kernel_const` (a scalar coefficient, entry point scan_const) and
// `_kernel_general` (a per-element coefficient, entry point scan_general).
//
// Bound: device-memory bytes (b read once, y written once, and a read once
// for scan_general).
//
// Design: one pass. The array is viewed as (G, N, M) with N the scan axis,
// through the strides the wrapper passes (no transpose). A block takes 32
// lines (one a lane) by a segment of 8 x SUB elements of the scan axis (SUB
// a warp: 16, or 32 for scan_const where the wrapper asks for it: along
// the contiguous axis). The TPU
// kernel carried the recurrence through VMEM scratch across grid steps
// that run in order; CUDA blocks run in no set order, so:
//   - within a segment, each thread scans its SUB elements from a zero
//     carry into an affine pair (A, B) (the product of a, and the local
//     sum), the pairs of a line's 8 warps are composed in shared memory (a
//     warp's lanes hold 32 lines, so that its loads coalesce), and each
//     thread then runs its SUB steps again from its carry-in;
//   - across segments, the carry comes by decoupled look-back: each block
//     publishes its segment's pair (status 1), looks back over the blocks
//     before it on its lines until one has published its inclusive value
//     (status 2), composes, and publishes its own inclusive value. Blocks
//     take their (line tile, segment) from a ticket counter, in segment
//     order, so every block waits only on blocks that already run.
// Arithmetic: the carry reaches an element through products of a (a^k for
// scan_const, by repeated multiplication), and every element is computed
// by the sequential step a * y + b from its piece's carry-in.
// Loads: where the scan axis is strided (M > 1) a warp's 32 lanes read 32
// consecutive m, coalesced. Where it is the contiguous one (M == 1) the
// block stages its 32 line segments through shared memory, by 16-byte loads
// where the strides and the alignment allow (else by element), and the
// lanes read them back transposed; y goes out the same way.
//
// The wrapper allocates and zeroes the look-back flags (one for each line
// of each block, and the ticket counter) and allocates the published pairs
// (`scan_storage` gives their sizes); the kernel allocates nothing. Without
// nvcc the file builds with a host C++ compiler into the same entry points,
// running the same blocks in ticket order with the same segment arithmetic
// and look-back (the CPU tests compare that build with the plain version).
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SCAN_FN __host__ __device__ __forceinline__
#else
#define __host__
#define __device__
#define __global__
#define SCAN_FN inline
#endif

typedef long long i64;

constexpr int kLanes = 32;                  // lines a block, one a lane
constexpr int kWarps = 8;                   // sub-segments a segment
constexpr int kThreads = kLanes * kWarps;

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
  int* flags;           // [0] the ticket counter, [1 + 32 t + l] the
                        // status of block t's line l (0, 1 or 2)
  float* pairs;         // block t: A[32], B[32], inclusive y[32]
  int seg;              // elements a segment: 8 x SUB
  int ntiles, nseg;
};

// A block's shared memory: the staged segments (M == 1 only; a only for
// scan_general), the sub-segment pairs and the carries. SUB elements a
// warp; the staged line pitch is the segment plus one, so that the
// transposed reads meet no bank conflicts.
template <int SUB, bool kConst, bool kContig>
struct Shared {
  static constexpr int kSub = SUB;
  static constexpr int kPitch = kWarps * SUB + 1;
  float b[kContig ? kLanes * kPitch : 1];     // staged segments, then y
  float a[kContig && !kConst ? kLanes * kPitch : 1];
  float A[kWarps][kLanes];      // sub-segment pairs, then their prefixes
  float B[kWarps][kLanes];
  float carry[kLanes];
  int ticket;
};

// The block of ticket t: line tile t % ntiles, segment t / ntiles, scan
// indices [n0, n0 + len).
struct Block {
  int t, tile, seg, n0, len;
};

SCAN_FN Block block_of(const ScanArgs& p, int t) {
  Block k;
  k.t = t;
  k.tile = t % p.ntiles;
  k.seg = t / p.ntiles;
  k.n0 = k.seg * p.seg;
  k.len = p.N - k.n0 < p.seg ? p.N - k.n0 : p.seg;
  return k;
}

SCAN_FN i64 lines_of(const ScanArgs& p) { return (i64)p.G * p.M; }

// Memory index along N of scan index i.
SCAN_FN i64 mem_n(const ScanArgs& p, int i) {
  return p.backward ? (i64)(p.N - 1 - i) : (i64)i;
}

// The memory range [lo, hi) along N of a block's segment.
SCAN_FN void seg_range(const ScanArgs& p, const Block& k, i64* lo, i64* hi) {
  if (p.backward) {
    *lo = p.N - k.n0 - k.len;
    *hi = p.N - k.n0;
  } else {
    *lo = k.n0;
    *hi = k.n0 + k.len;
  }
}

// M == 1: copy the segment of each of the block's lines from `src` (line g
// at src + g * sg, element n at n * sn) into dst[l * pitch + (scan index -
// n0)], in 4-element chunks: one 16-byte load where the chunk lies inside
// the segment and the strides and alignment allow, else by element.
SCAN_FN void stage_in(const ScanArgs& p, const Block& k, const float* src,
                      i64 sg, i64 sn, float* dst, int pitch, int tid,
                      int nth) {
  i64 lo, hi;
  seg_range(p, k, &lo, &hi);
  const bool vec = sn == 1 && sg % 4 == 0 && (uintptr_t)src % 16 == 0;
  const i64 c0 = lo & ~(i64)3;
  const int nchunk = (int)((hi - c0 + 3) / 4);
  const i64 lines = lines_of(p);
  for (int i = tid; i < kLanes * nchunk; i += nth) {
    const int l = i / nchunk;
    const i64 g = (i64)k.tile * kLanes + l;
    if (g >= lines) continue;
    const i64 n = c0 + 4 * (i64)(i % nchunk);
    float v[4];
    if (vec && n >= lo && n + 4 <= hi) {
#ifdef __CUDA_ARCH__
      const float4 q = *(const float4*)(src + g * sg + n);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
#else
      for (int j = 0; j < 4; ++j) v[j] = src[g * sg + n + j];
#endif
    } else {
      for (int j = 0; j < 4; ++j)
        if (n + j >= lo && n + j < hi) v[j] = src[g * sg + (n + j) * sn];
    }
    for (int j = 0; j < 4; ++j) {
      const i64 nn = n + j;
      if (nn < lo || nn >= hi) continue;
      const i64 s = p.backward ? (p.N - 1 - nn) - k.n0 : nn - k.n0;
      dst[l * pitch + s] = v[j];
    }
  }
}

// M == 1: write the block's y back from src[l * pitch + s], as stage_in
// reads.
SCAN_FN void stage_out(const ScanArgs& p, const Block& k, const float* src,
                       int pitch, int tid, int nth) {
  i64 lo, hi;
  seg_range(p, k, &lo, &hi);
  const bool vec = p.ysn == 1 && p.ysg % 4 == 0 && (uintptr_t)p.y % 16 == 0;
  const i64 c0 = lo & ~(i64)3;
  const int nchunk = (int)((hi - c0 + 3) / 4);
  const i64 lines = lines_of(p);
  for (int i = tid; i < kLanes * nchunk; i += nth) {
    const int l = i / nchunk;
    const i64 g = (i64)k.tile * kLanes + l;
    if (g >= lines) continue;
    const i64 n = c0 + 4 * (i64)(i % nchunk);
    float v[4];
    for (int j = 0; j < 4; ++j) {
      const i64 nn = n + j;
      if (nn < lo || nn >= hi) continue;
      const i64 s = p.backward ? (p.N - 1 - nn) - k.n0 : nn - k.n0;
      v[j] = src[l * pitch + s];
    }
    if (vec && n >= lo && n + 4 <= hi) {
#ifdef __CUDA_ARCH__
      *(float4*)(p.y + g * p.ysg + n) = make_float4(v[0], v[1], v[2], v[3]);
#else
      for (int j = 0; j < 4; ++j) p.y[g * p.ysg + n + j] = v[j];
#endif
    } else {
      for (int j = 0; j < 4; ++j)
        if (n + j >= lo && n + j < hi) p.y[g * p.ysg + (n + j) * p.ysn] = v[j];
    }
  }
}

// Thread (lane l, warp w): load its sub-segment of line tile * 32 + l into
// vb/va (from the staged segment where M == 1, else from device memory,
// lanes on consecutive m), scan it from a zero carry and leave its pair in
// sh.A/B[w][l].
template <bool kConst, bool kContig, class Sh>
SCAN_FN void load_and_reduce(const ScanArgs& p, const Block& k, Sh& sh,
                             int l, int w, float* vb, float* va) {
  constexpr int kSub = Sh::kSub, kPitch = Sh::kPitch;
  const i64 line = (i64)k.tile * kLanes + l;
  const bool valid = line < lines_of(p);
  const i64 g = kContig ? line : line / p.M;
  const i64 m = kContig ? 0 : line % p.M;
  float A = 1.0f, B = 0.0f;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const int s = w * kSub + j;
    if (!valid || s >= k.len) continue;
    float bv, av;
    if constexpr (kContig) {
      bv = sh.b[l * kPitch + s];
      av = kConst ? p.a_const : sh.a[l * kPitch + s];
    } else {
      const i64 n = mem_n(p, k.n0 + s);
      bv = p.b[g * p.bsg + n * p.bsn + m * p.bsm];
      av = kConst ? p.a_const : p.a[g * p.asg + n * p.asn + m * p.asm_];
    }
    vb[j] = bv;
    va[j] = av;
    A = av * A;
    B = av * B + bv;
  }
  sh.A[w][l] = A;
  sh.B[w][l] = B;
}

#ifdef __CUDA_ARCH__
SCAN_FN int ld_status(const int* f) { return *(const volatile int*)f; }
SCAN_FN float ld_pair(const float* f) { return __ldcg(f); }
SCAN_FN void publish_fence() { __threadfence(); }
#else
inline int ld_status(const int* f) { return *f; }
inline float ld_pair(const float* f) { return *f; }
inline void publish_fence() {}
#endif

// Lane l of warp 0 (all 32 lanes together), first half: compose line l's
// sub-segment pairs into their exclusive prefixes (left in sh.A/B) and the
// segment's pair (sh.carry[l] holds its A, `seg_b` its B until the look-
// back), and publish: the first segment its inclusive value (status 2), a
// later one its pair (status 1).
template <class Sh>
SCAN_FN void publish(const ScanArgs& p, const Block& k, Sh& sh, int l,
                     float* seg_b) {
  float pa = 1.0f, pb = 0.0f;
  for (int w = 0; w < kWarps; ++w) {
    const float Aw = sh.A[w][l], Bw = sh.B[w][l];
    sh.A[w][l] = pa;
    sh.B[w][l] = pb;
    pb = Aw * pb + Bw;
    pa = Aw * pa;
  }
  const i64 line = (i64)k.tile * kLanes + l;
  float* mine = p.pairs + (i64)k.t * 3 * kLanes;
  // one flag a lane: each lane's payload is ordered before its own flag by
  // its own fence
  int* status = p.flags + 1 + (i64)k.t * kLanes + l;
  if (k.seg == 0) {
    float carry = 0.0f;
    if (line < lines_of(p)) {
      const i64 g = line / p.M, m = line % p.M;
      carry = p.init[g * p.isg + m * p.ism];
    }
    mine[2 * kLanes + l] = pa * carry + pb;
    publish_fence();
    *(volatile int*)status = 2;
    sh.carry[l] = carry;
    return;
  }
  mine[l] = pa;
  mine[kLanes + l] = pb;
  publish_fence();
  *(volatile int*)status = 1;
  sh.carry[l] = pa;
  *seg_b = pb;
}

// Second half, for a segment after the first: look back over the blocks
// before it on line l, composing their pairs until one has published its
// inclusive value, publish this block's inclusive value, and leave the
// carry into the segment in sh.carry[l].
template <class Sh>
SCAN_FN void look_back(const ScanArgs& p, const Block& k, Sh& sh, int l,
                       float seg_b) {
  if (k.seg == 0) return;
  const float pa = sh.carry[l];
  float accA = 1.0f, accB = 0.0f, carry;
  for (int j = k.t - p.ntiles;; j -= p.ntiles) {
    const int* flag = p.flags + 1 + (i64)j * kLanes + l;
    int st;
    while ((st = ld_status(flag)) == 0) {
    }
    publish_fence();
    const float* theirs = p.pairs + (i64)j * 3 * kLanes;
    if (st == 2) {
      carry = accA * ld_pair(theirs + 2 * kLanes + l) + accB;
      break;
    }
    const float Aj = ld_pair(theirs + l), Bj = ld_pair(theirs + kLanes + l);
    accB = accA * Bj + accB;
    accA = accA * Aj;
  }
  p.pairs[(i64)k.t * 3 * kLanes + 2 * kLanes + l] = pa * carry + seg_b;
  publish_fence();
  *(volatile int*)(p.flags + 1 + (i64)k.t * kLanes + l) = 2;
  sh.carry[l] = carry;
}

// Thread (lane l, warp w): its carry-in from the prefix and the segment's
// carry, then its SUB steps again, y out (to the staged segment where M ==
// 1, else straight to device memory).
template <bool kConst, bool kContig, class Sh>
SCAN_FN void apply(const ScanArgs& p, const Block& k, Sh& sh, int l,
                   int w, const float* vb, const float* va) {
  constexpr int kSub = Sh::kSub, kPitch = Sh::kPitch;
  const i64 line = (i64)k.tile * kLanes + l;
  if (line >= lines_of(p)) return;
  const i64 g = kContig ? line : line / p.M;
  const i64 m = kContig ? 0 : line % p.M;
  float y = sh.A[w][l] * sh.carry[l] + sh.B[w][l];
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const int s = w * kSub + j;
    if (s >= k.len) continue;
    y = va[j] * y + vb[j];
    if constexpr (kContig) {
      sh.b[l * kPitch + s] = y;
    } else {
      const i64 n = mem_n(p, k.n0 + s);
      p.y[g * p.ysg + n * p.ysn + m * p.ysm] = y;
    }
  }
}

#ifdef __CUDACC__
template <int SUB, bool kConst, bool kContig>
__global__ void __launch_bounds__(kThreads) scan_segments(ScanArgs p) {
  using Sh = Shared<SUB, kConst, kContig>;
  __shared__ Sh sh;
  const int tid = threadIdx.x, l = tid % kLanes, w = tid / kLanes;
  if (tid == 0) sh.ticket = atomicAdd(p.flags, 1);
  __syncthreads();
  const Block k = block_of(p, sh.ticket);
  if constexpr (kContig) {
    stage_in(p, k, p.b, p.bsg, p.bsn, sh.b, Sh::kPitch, tid, kThreads);
    if (!kConst)
      stage_in(p, k, p.a, p.asg, p.asn, sh.a, Sh::kPitch, tid, kThreads);
    __syncthreads();
  }
  float vb[SUB], va[SUB];
  load_and_reduce<kConst, kContig>(p, k, sh, l, w, vb, va);
  __syncthreads();
  if (w == 0) {
    float seg_b = 0.0f;
    publish(p, k, sh, l, &seg_b);
    look_back(p, k, sh, l, seg_b);
  }
  __syncthreads();
  apply<kConst, kContig>(p, k, sh, l, w, vb, va);
  if constexpr (kContig) {
    __syncthreads();
    stage_out(p, k, sh.b, Sh::kPitch, tid, kThreads);
  }
}

template <int SUB, bool kConst>
static void launch_one(const ScanArgs& p, cudaStream_t s) {
  const int blocks = p.ntiles * p.nseg;
  if (p.M == 1) {
    scan_segments<SUB, kConst, true><<<blocks, kThreads, 0, s>>>(p);
  } else {
    scan_segments<SUB, kConst, false><<<blocks, kThreads, 0, s>>>(p);
  }
}

// SUB is 16, or 32 for scan_const (a 32-element scan_general segment of
// both a and b would pass the 48 KB of static shared memory).
static int run(const ScanArgs& p, void* stream) {
  if (lines_of(p) == 0 || p.N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int sub = p.seg / kWarps;
  if (p.a == nullptr && sub == 32) {
    launch_one<32, true>(p, s);
  } else if (p.a == nullptr && sub == 16) {
    launch_one<16, true>(p, s);
  } else if (p.a != nullptr && sub == 16) {
    launch_one<16, false>(p, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#else
// The same blocks in ticket order, each block's threads one after another
// within each of its phases (the card's barriers), every thread's
// registers kept between phases. Blocks go in waves of kHostWave: each
// publishes in ticket order, then they look back in reverse order, so that
// a block can find the blocks before it published but not done, as on the
// card, and compose their pairs.
constexpr int kHostWave = 8;

template <int SUB, bool kConst, bool kContig>
static void host_blocks(const ScanArgs& p) {
  using Sh = Shared<SUB, kConst, kContig>;
  static Sh sh[kHostWave];
  static float vb[kHostWave][kThreads][SUB], va[kHostWave][kThreads][SUB];
  static float seg_b[kHostWave][kLanes];
  const int nblk = p.ntiles * p.nseg;
  Block ks[kHostWave];
  for (int t0 = 0; t0 < nblk; t0 += kHostWave) {
    const int nw = nblk - t0 < kHostWave ? nblk - t0 : kHostWave;
    for (int q = 0; q < nw; ++q) {
      const Block k = ks[q] = block_of(p, p.flags[0]++);
      if constexpr (kContig) {
        stage_in(p, k, p.b, p.bsg, p.bsn, sh[q].b, Sh::kPitch, 0, 1);
        if (!kConst)
          stage_in(p, k, p.a, p.asg, p.asn, sh[q].a, Sh::kPitch, 0, 1);
      }
      for (int tid = 0; tid < kThreads; ++tid)
        load_and_reduce<kConst, kContig>(p, k, sh[q], tid % kLanes,
                                         tid / kLanes, vb[q][tid],
                                         va[q][tid]);
      for (int l = 0; l < kLanes; ++l) publish(p, k, sh[q], l, &seg_b[q][l]);
    }
    for (int q = nw - 1; q >= 0; --q) {
      for (int l = 0; l < kLanes; ++l)
        look_back(p, ks[q], sh[q], l, seg_b[q][l]);
      for (int tid = 0; tid < kThreads; ++tid)
        apply<kConst, kContig>(p, ks[q], sh[q], tid % kLanes, tid / kLanes,
                               vb[q][tid], va[q][tid]);
      if constexpr (kContig) stage_out(p, ks[q], sh[q].b, Sh::kPitch, 0, 1);
    }
  }
}

template <int SUB, bool kConst>
static void host_one(const ScanArgs& p) {
  if (p.M == 1) {
    host_blocks<SUB, kConst, true>(p);
  } else {
    host_blocks<SUB, kConst, false>(p);
  }
}

static int run(const ScanArgs& p, void*) {
  if (lines_of(p) == 0 || p.N == 0) return 0;
  const int sub = p.seg / kWarps;
  if (p.a == nullptr && sub == 32) {
    host_one<32, true>(p);
  } else if (p.a == nullptr && sub == 16) {
    host_one<16, true>(p);
  } else if (p.a != nullptr && sub == 16) {
    host_one<16, false>(p);
  } else {
    return 1;
  }
  return 0;
}
#endif

static ScanArgs make_args(const float* a, i64 asg, i64 asn, i64 asm_,
                          float a_const, const float* b, i64 bsg, i64 bsn,
                          i64 bsm, const float* init, i64 isg, i64 ism,
                          float* y, i64 ysg, i64 ysn, i64 ysm, int G, int N,
                          int M, int backward, int sub, int* flags,
                          float* pairs) {
  ScanArgs p{a, asg, asn, asm_, a_const, b, bsg, bsn, bsm, init, isg, ism,
             y, ysg, ysn, ysm, G, N, M, backward, flags, pairs, kWarps * sub,
             0, 0};
  p.ntiles = (int)(((i64)G * M + kLanes - 1) / kLanes);
  p.nseg = (N + p.seg - 1) / p.seg;
  return p;
}

// The look-back storage a call needs: (ints of flags, floats of pairs).
extern "C" void scan_storage(int G, int N, int M, int sub, i64* nflags,
                             i64* npairs) {
  const int seg = kWarps * sub;
  const i64 blocks = (((i64)G * M + kLanes - 1) / kLanes) *
                     (i64)((N + seg - 1) / seg);
  *nflags = 1 + blocks * kLanes;
  *npairs = blocks * 3 * kLanes;
}

extern "C" int scan_const(const float* b, i64 bsg, i64 bsn, i64 bsm,
                          float a, const float* init, i64 isg, i64 ism,
                          float* y, i64 ysg, i64 ysn, i64 ysm, int G, int N,
                          int M, int backward, int sub, int* flags,
                          float* pairs, void* stream) {
  return run(make_args(nullptr, 0, 0, 0, a, b, bsg, bsn, bsm, init, isg, ism,
                       y, ysg, ysn, ysm, G, N, M, backward, sub, flags,
                       pairs),
             stream);
}

extern "C" int scan_general(const float* a, i64 asg, i64 asn, i64 asm_,
                            const float* b, i64 bsg, i64 bsn, i64 bsm,
                            const float* init, i64 isg, i64 ism, float* y,
                            i64 ysg, i64 ysn, i64 ysm, int G, int N, int M,
                            int backward, int sub, int* flags, float* pairs,
                            void* stream) {
  return run(make_args(a, asg, asn, asm_, 0.0f, b, bsg, bsn, bsm, init, isg,
                       ism, y, ysg, ysn, ysm, G, N, M, backward, sub, flags,
                       pairs),
             stream);
}
