// Fixed helpers of the stencil-group kernel (ops/group_kernel.py).
//
// ops/group_kernel.py emits one .cu per stencil group that holds only the
// member Funcs' point expressions and their footprint arithmetic, and
// includes this header for everything else:
//   - the reference's integer semantics: floor division and floor modulo
//     with x/0 == x%0 == 0, and wrapping arithmetic at every width
//     (u16/u32 included), computed through a wider unsigned type so that
//     no signed overflow (undefined in C++) can occur;
//   - Halide casts (float -> int truncates toward zero, then wraps), bit
//     counts, division rounded toward zero and bit casts;
//   - 16-bit floats (float16 and bfloat16): __half and __nv_bfloat16 on the
//     card, a 16-bit stand-in holding the bits in the host build; each
//     operation is computed in f32 and rounded back to the type (round to
//     nearest even), as the plain version's torch ops do;
//   - the shift-inwards origin of the last sub-tile (Schedule.h
//     ShiftInwards);
//   - staging of a halo'd window of an input into shared memory: where the
//     window lies inside the realized region, row by row in 16-byte pieces
//     by cp.async (8 or 4 where the strides allow no more; each row's head
//     and tail by element), else element by element, edge-replicated.
//
// Every helper is __host__ __device__ so that the emitted point functions
// also compile with a host C++ compiler, where the CUDA qualifiers below
// are defined empty (the CPU tests compare them with the plain version).
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __global__
#endif

#define HL_FN __host__ __device__ inline

// --- 16-bit floats -------------------------------------------------------------

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_fp16.h>
typedef __half hl_f16;
typedef __nv_bfloat16 hl_bf16;
#else
struct hl_f16 {
  uint16_t bits;
};
struct hl_bf16 {
  uint16_t bits;
};
#endif

template <typename T>
struct hl_is_half : std::false_type {};
template <>
struct hl_is_half<hl_f16> : std::true_type {};
template <>
struct hl_is_half<hl_bf16> : std::true_type {};

// A float type: the C++ ones and the two 16-bit ones.
template <typename T>
struct hl_is_float
    : std::integral_constant<bool, std::is_floating_point<T>::value ||
                                       hl_is_half<T>::value> {};

HL_FN uint32_t hl_f32_bits(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}

HL_FN float hl_bits_f32(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// IEEE binary16 bits -> f32 (exact), and f32 -> binary16 bits rounded to
// nearest even (subnormals, inf and NaN included): the host's conversions,
// where the card has instructions.
HL_FN float hl_f16_bits_to_f32(uint16_t h) {
  const uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  const int e = (h >> 10) & 0x1f;
  uint32_t m = h & 0x3ff;
  if (e == 0x1f) return hl_bits_f32(sign | 0x7f800000u | (m << 13));
  if (e != 0) return hl_bits_f32(sign | ((uint32_t)(e + 112) << 23) | (m << 13));
  if (m == 0) return hl_bits_f32(sign);
  int s = 0;                                  // a subnormal: normalise it
  while (!(m & 0x400)) {
    m <<= 1;
    ++s;
  }
  return hl_bits_f32(sign | ((uint32_t)(113 - s) << 23) | ((m & 0x3ff) << 13));
}

HL_FN uint16_t hl_f32_to_f16_bits(float f) {
  const uint32_t u = hl_f32_bits(f);
  const uint16_t sign = (uint16_t)((u >> 16) & 0x8000);
  const uint32_t a = u & 0x7fffffffu;
  if (a > 0x7f800000u) return (uint16_t)(sign | 0x7e00);      // NaN
  if (a >= 0x477ff000u) return (uint16_t)(sign | 0x7c00);     // to inf
  if (a < 0x38800000u) {                     // below 2^-14: subnormal or 0
    if (a < 0x33000000u) return sign;        // below half the least: 0
    const int e = (int)(a >> 23);
    const uint32_t m = (a & 0x7fffffu) | 0x800000u;
    const int shift = 126 - e;               // 14..24
    uint32_t r = m >> shift;
    const uint32_t rem = m & ((1u << shift) - 1);
    const uint32_t half = 1u << (shift - 1);
    if (rem > half || (rem == half && (r & 1))) ++r;
    return (uint16_t)(sign | r);
  }
  uint32_t r = ((a >> 13) - (112u << 10));
  const uint32_t rem = a & 0x1fff;
  if (rem > 0x1000 || (rem == 0x1000 && (r & 1))) ++r;
  return (uint16_t)(sign | r);
}

HL_FN uint16_t hl_f32_to_bf16_bits(float f) {
  const uint32_t u = hl_f32_bits(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;   // NaN, as c10
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1)) >> 16);
}

// The value of a float as f32 (16-bit floats widen exactly).
HL_FN float hl_f32(float v) { return v; }
HL_FN double hl_f32(double v) { return v; }

HL_FN float hl_f32(hl_f16 v) {
#ifdef __CUDA_ARCH__
  return __half2float(v);
#else
  uint16_t h;
  memcpy(&h, &v, 2);
  return hl_f16_bits_to_f32(h);
#endif
}

HL_FN float hl_f32(hl_bf16 v) {
#ifdef __CUDA_ARCH__
  return __bfloat162float(v);
#else
  uint16_t h;
  memcpy(&h, &v, 2);
  return hl_bits_f32((uint32_t)h << 16);
#endif
}

// An f32 rounded to the 16-bit float type T, to nearest even.
template <typename T>
HL_FN T hl_round16(float f) {
  static_assert(hl_is_half<T>::value, "hl_round16: not a 16-bit float");
#ifdef __CUDA_ARCH__
  if constexpr (std::is_same<T, hl_f16>::value) return __float2half_rn(f);
  else return __float2bfloat16_rn(f);
#else
  const uint16_t h = std::is_same<T, hl_f16>::value ? hl_f32_to_f16_bits(f)
                                                    : hl_f32_to_bf16_bits(f);
  T r;
  memcpy(&r, &h, 2);
  return r;
#endif
}

// --- wrapping integer arithmetic --------------------------------------------

// The unsigned type an integer of type T is computed in: at least 32 bits,
// so that the usual promotions never make a signed int that could overflow.
template <typename T>
using hl_wide_u = typename std::conditional<(sizeof(T) > 4), uint64_t,
                                            uint32_t>::type;

template <typename T>
HL_FN T hl_add(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) {
    return a + b;
  } else {
    return (T)((hl_wide_u<T>)a + (hl_wide_u<T>)b);
  }
}

template <typename T>
HL_FN T hl_sub(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) {
    return a - b;
  } else {
    return (T)((hl_wide_u<T>)a - (hl_wide_u<T>)b);
  }
}

template <typename T>
HL_FN T hl_mul(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) {
    return a * b;
  } else {
    return (T)((hl_wide_u<T>)a * (hl_wide_u<T>)b);
  }
}

// Floor division with x/0 == 0 (reference: src/IROperator.h div_imp).
template <typename T>
HL_FN T hl_div(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) {
    return a / b;
  } else {
    if (b == 0) return (T)0;
    if constexpr (std::is_signed<T>::value) {
      if (b == (T)-1) return (T)((hl_wide_u<T>)0 - (hl_wide_u<T>)a);
      T q = (T)(a / b);
      if ((T)(a % b) != 0 && ((a < 0) != (b < 0))) q = (T)(q - 1);
      return q;
    } else {
      return (T)(a / b);
    }
  }
}

// Floor modulo with x%0 == 0; for floats a - b*floor(a/b).
template <typename T>
HL_FN T hl_mod(T a, T b) {
  if constexpr (std::is_same<T, float>::value) {
    return a - b * floorf(a / b);
  } else if constexpr (std::is_floating_point<T>::value) {
    return a - b * floor(a / b);
  } else {
    if (b == 0) return (T)0;
    if constexpr (std::is_signed<T>::value) {
      if (b == (T)-1) return (T)0;
      T r = (T)(a % b);
      if (r != 0 && ((r < 0) != (b < 0))) r = (T)(r + b);
      return r;
    } else {
      return (T)(a % b);
    }
  }
}

// min/max propagate NaN, as torch.minimum/maximum and jnp.minimum do.
template <typename T>
HL_FN T hl_min(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) {
    if (a != a) return a;
    if (b != b) return b;
  }
  return a < b ? a : b;
}

template <typename T>
HL_FN T hl_max(T a, T b) {
  if constexpr (std::is_floating_point<T>::value) {
    if (a != a) return a;
    if (b != b) return b;
  }
  return a > b ? a : b;
}

// argmax (MAX) / argmin: does a point of value v replace the best so far?
// Where it is more extreme, or a NaN where the best is not; on a tie (or
// both NaN) where it comes first in the RDom's order (`first`): the first
// extreme point of the flattened RDom, as torch.argmax and jnp.argmax.
template <bool MAX, typename T>
HL_FN bool hl_arg_better(T v, T best, bool first) {
  if constexpr (std::is_floating_point<T>::value) {
    const bool vn = v != v, bn = best != best;
    if (vn || bn) return vn && (!bn || first);
  }
  if (v == best) return first;
  return MAX ? v > best : v < best;
}

// Shifts by a count outside [0, bits) give 0 (or the sign for a right
// shift of a negative value), as XLA's shifts do; a u64 count is compared
// as unsigned.
template <typename T>
HL_FN T hl_shl(T a, T b) {
  constexpr int bits = 8 * (int)sizeof(T);
  if (b < 0 || (unsigned long long)b >= (unsigned long long)bits) return (T)0;
  return (T)((hl_wide_u<T>)a << (int)b);
}

template <typename T>
HL_FN T hl_shr(T a, T b) {
  constexpr int bits = 8 * (int)sizeof(T);
  if (b < 0 || (unsigned long long)b >= (unsigned long long)bits) {
    if constexpr (std::is_signed<T>::value) return a < 0 ? (T)-1 : (T)0;
    return (T)0;
  }
  return (T)(a >> (int)b);
}

// |a - b| in the unsigned type of a signed T (Halide's absd): the
// difference wraps in T, and the cast to R reads it modulo 2^bits.
template <typename R, typename T>
HL_FN R hl_absd(T a, T b) {
  return (R)(a > b ? hl_sub<T>(a, b) : hl_sub<T>(b, a));
}

template <typename T>
HL_FN T hl_abs(T a) {
  if constexpr (std::is_floating_point<T>::value) {
    return a < 0 ? -a : a;
  } else if constexpr (std::is_signed<T>::value) {
    return a < 0 ? (T)((hl_wide_u<T>)0 - (hl_wide_u<T>)a) : a;
  } else {
    return a;
  }
}

// --- casts --------------------------------------------------------------------

// Halide cast: to bool is != 0; float -> integer truncates toward zero and
// then wraps into the destination width (float -> u64 as XLA converts);
// integer narrowing wraps.
template <typename To, typename From>
HL_FN To hl_cast(From v) {
  if constexpr (std::is_same<To, From>::value) {
    return v;
  } else if constexpr (hl_is_half<From>::value) {
    // through f32: exact, then as from f32
    return hl_cast<To, float>(hl_f32(v));
  } else if constexpr (hl_is_half<To>::value) {
    // through f32, as torch converts (an integer or a double is rounded to
    // f32 first)
    return hl_round16<To>(hl_cast<float, From>(v));
  } else if constexpr (std::is_same<To, bool>::value) {
    return v != (From)0;
  } else if constexpr (std::is_floating_point<To>::value) {
    return (To)v;
  } else if constexpr (std::is_floating_point<From>::value &&
                       std::is_same<To, uint64_t>::value) {
    // as eval_torch's _float_to_u64 (XLA's conversion): NaN and values
    // below 0 give 0, 2^64 and above 2^64 - 1; from 2^63 on, 2^63 less
    // is truncated and the top bit set; each part capped at 2^63 - 2^40
    if (!(v > (From)0)) return 0;
    if (v >= (From)18446744073709551616.0) return ~(uint64_t)0;
    const bool big = v >= (From)9223372036854775808.0;
    From w = big ? v - (From)9223372036854775808.0 : v;
    if (w > (From)9223370937343148032.0) w = (From)9223370937343148032.0;
    const uint64_t r = (uint64_t)(int64_t)w;
    return big ? r ^ ((uint64_t)1 << 63) : r;
  } else if constexpr (std::is_floating_point<From>::value) {
    return (To)(uint64_t)(int64_t)v;
  } else {
    return (To)(uint64_t)(int64_t)v;
  }
}

// The range of an integer type (not std::numeric_limits, whose members
// are host functions).
template <typename T>
HL_FN constexpr T hl_int_max() {
  return std::is_signed<T>::value
             ? (T)((((uint64_t)1) << (8 * sizeof(T) - 1)) - 1)
             : (T)(~(uint64_t)0);
}

template <typename T>
HL_FN constexpr T hl_int_min() {
  return std::is_signed<T>::value ? (T)(-(int64_t)hl_int_max<T>() - 1)
                                  : (T)0;
}

// Halide saturating_cast, as the JAX package computes it: float -> float is
// a plain cast; float -> integer clips to the target's range and truncates,
// NaN giving 0 and a bound the float type rounds up (2^31 in f32) giving
// the target's maximum; integer -> integer clamps in a type wide enough for
// both.
template <typename To, typename From>
HL_FN To hl_saturating_cast(From v) {
  if constexpr (std::is_floating_point<To>::value) {
    return (To)v;
  } else if constexpr (std::is_floating_point<From>::value) {
    if (v != v) return (To)0;
    if (v <= (From)hl_int_min<To>()) return hl_int_min<To>();
    if (v >= (From)hl_int_max<To>()) return hl_int_max<To>();
    return (To)v;
  } else if constexpr (std::is_unsigned<From>::value && sizeof(From) == 8) {
    return v > (uint64_t)hl_int_max<To>() ? hl_int_max<To>() : (To)v;
  } else {
    const int64_t w = (int64_t)v;
    if (w < (int64_t)hl_int_min<To>()) return hl_int_min<To>();
    if constexpr (!(std::is_unsigned<To>::value && sizeof(To) == 8)) {
      if (w > (int64_t)hl_int_max<To>()) return hl_int_max<To>();
    }
    return (To)w;
  }
}

// --- bit counts, division rounded toward zero, bit casts ----------------------

// The bits of an integer type, as the unsigned type of its width.
template <typename T>
using hl_bits_t = typename std::make_unsigned<T>::type;

template <typename T>
HL_FN int hl_popcount(T v) {
  const hl_bits_t<T> u = (hl_bits_t<T>)v;
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) > 4) return __popcll((unsigned long long)u);
  else return __popc((unsigned)u);
#else
  if constexpr (sizeof(T) > 4) return __builtin_popcountll(u);
  else return __builtin_popcount((unsigned)u);
#endif
}

// Leading zeros among T's bits, T's bits for 0: the count over 32 bits
// (or 64) less the bits above T's width.
template <typename T>
HL_FN int hl_clz(T v) {
  constexpr int bits = 8 * (int)sizeof(T);
  const hl_bits_t<T> u = (hl_bits_t<T>)v;
#ifdef __CUDA_ARCH__
  if constexpr (bits > 32) return __clzll((long long)u);
  else return __clz((int)(unsigned)u) - (32 - bits);
#else
  if (u == 0) return bits;
  if constexpr (bits > 32) return __builtin_clzll(u);
  else return __builtin_clz((unsigned)u) - (32 - bits);
#endif
}

// Trailing zeros, T's bits for 0: __ffs numbers the lowest set bit from 1
// and gives 0 for 0.
template <typename T>
HL_FN int hl_ctz(T v) {
  constexpr int bits = 8 * (int)sizeof(T);
  const hl_bits_t<T> u = (hl_bits_t<T>)v;
#ifdef __CUDA_ARCH__
  int f;
  if constexpr (bits > 32) f = __ffsll((long long)u);
  else f = __ffs((int)(unsigned)u);
#else
  int f;
  if constexpr (bits > 32) f = __builtin_ffsll((long long)u);
  else f = __builtin_ffs((int)(unsigned)u);
#endif
  return f == 0 ? bits : f - 1;
}

// Division rounded toward zero (C's / and %) with x/0 == x%0 == 0, and the
// signed minimum over -1 giving itself (remainder 0), as XLA gives; for
// floats a / b and fmod, 0 where b == 0.
template <typename T>
HL_FN T hl_div_rtz(T a, T b) {
  if (b == (T)0) return (T)0;
  if constexpr (std::is_floating_point<T>::value) {
    return a / b;
  } else {
    if constexpr (std::is_signed<T>::value) {
      if (b == (T)-1) return (T)((hl_wide_u<T>)0 - (hl_wide_u<T>)a);
    }
    return (T)(a / b);
  }
}

template <typename T>
HL_FN T hl_mod_rtz(T a, T b) {
  if (b == (T)0) return (T)0;
  if constexpr (std::is_same<T, float>::value) {
    return fmodf(a, b);
  } else if constexpr (std::is_floating_point<T>::value) {
    return fmod(a, b);
  } else {
    if constexpr (std::is_signed<T>::value) {
      if (b == (T)-1) return (T)0;
    }
    return (T)(a % b);
  }
}

// The bits of a From read as a To of the same width.
template <typename To, typename From>
HL_FN To hl_reinterpret(From v) {
  static_assert(sizeof(To) == sizeof(From), "reinterpret: widths differ");
  To r;
  memcpy(&r, &v, sizeof(To));
  return r;
}

// --- tiling -------------------------------------------------------------------

// Origin of sub-tile `t` of size `tile` over [mn, mn + ext): the last one
// is shifted inwards to end at the extent, so that no read leaves the
// required region (reference: Schedule.h TailStrategy::ShiftInwards).
HL_FN int hl_shift_inwards(int mn, int ext, int tile, int t) {
  const int o = mn + t * tile;
  const int last = mn + ext - tile;
  return o < last ? o : last;
}

HL_FN int hl_clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A window of an input: the realized region in device memory it is read
// from (element strides, realized mins and sizes per pipeline dim).
// `unit` is set by the launcher (hl_copy_unit): 0 where dim 0 is strided.
template <int ND>
struct HlInput {
  const void* ptr;
  long long stride[ND];
  int rmin[ND];
  int rsize[ND];
  int unit;
};

// The source element of window element i (coords(i) over `ext`, dim 0
// fastest), clamped into the realized region.
template <typename T, int ND>
HL_FN const T* hl_window_src(const HlInput<ND>& in, const int* lo,
                             const int* ext, int i) {
  long long off = 0;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int c = i % ext[d];
    i /= ext[d];
    const int g = hl_clampi(lo[d] + c - in.rmin[d], 0, in.rsize[d] - 1);
    off += (long long)g * in.stride[d];
  }
  return (const T*)in.ptr + off;
}

// --- staging ------------------------------------------------------------------

// A block barrier on the card; the host build runs one thread a block.
HL_FN void hl_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

// Copy `n` bytes (1, 2, 4, 8 or 16), `dst` and `src` both aligned to n:
// 4, 8 and 16 by cp.async on the card (in flight until hl_async_wait(); the
// thread goes on meanwhile), 1 and 2 by a load and a store. The host build
// copies at once.
HL_FN void hl_copy_piece(void* dst, const void* src, int n) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  switch (n) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                   "l"(src));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(src));
      break;
    case 2:
      *(uint16_t*)dst = *(const uint16_t*)src;
      break;
    default:
      *(uint8_t*)dst = *(const uint8_t*)src;
  }
#else
  memcpy(dst, src, (size_t)n);
#endif
}

// Wait for this thread's cp.async copies (the barrier after it makes every
// thread's visible).
HL_FN void hl_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// The copy unit of an input: the widest of 16, 8 and 4 bytes (at least the
// element) that divides every row stride (dims 1..ND-1) in bytes, so that
// all rows of a window start at one phase modulo the unit; 0 where dim 0
// is strided (no rows to copy). Computed once, by the launcher.
template <typename T, int ND>
HL_FN int hl_copy_unit(const HlInput<ND>& in) {
  if (in.stride[0] != 1) return 0;
  int u = 16;
  for (int d = 1; d < ND; ++d) {
    const long long b = in.stride[d] * (long long)sizeof(T);
    while (u > (int)sizeof(T) && b % u != 0) u >>= 1;
  }
  return u > (int)sizeof(T) ? u : (int)sizeof(T);
}

// Where a window over [lo, lo + ext) lies inside the realized region and
// dim 0 has unit stride: the phase of its first element modulo the copy
// unit, in elements (>= 0). The window's shared-memory buffer starts that
// many elements after its 16-byte-aligned base, so each row sits at its
// source's phase. Elsewhere -1: the block takes the edge path.
template <typename T, int ND>
HL_FN int hl_window_phase(const HlInput<ND>& in, const int* lo,
                          const int* ext) {
  if (in.unit == 0) return -1;
  long long off = 0;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    if (lo[d] < in.rmin[d] || lo[d] + ext[d] > in.rmin[d] + in.rsize[d])
      return -1;
    off += (long long)(lo[d] - in.rmin[d]) * in.stride[d];
  }
  const uintptr_t a = (uintptr_t)((const T*)in.ptr + off);
  return (int)((a & (uintptr_t)(in.unit - 1)) / sizeof(T));
}

// Stage window[r * pitch + c0] = input[lo + coords] for every element of a
// window over `ext`, threads tid, tid + nth, ... sharing the work. With
// phase >= 0 (the window lies inside the region; `window` is the buffer's
// 16-byte-aligned base plus the phase) each row is cut at the 16-byte
// boundaries of shared memory; a thread takes one such chunk of a row and
// copies it in pieces of the copy unit, by element where a piece runs past
// the row's head or tail. With phase -1 each element is gathered with its
// coordinates clamped into the region (repeat_edge semantics: the clamps
// stripped from the point expressions are restored here), 4- and 8-byte
// elements by cp.async too. `ext` and `pitch` are the emitted constants, so
// the divisions below are by constants.
template <typename T, int ND>
HL_FN void hl_stage_window(T* window, int phase, int pitch,
                           const HlInput<ND>& in, const int* lo,
                           const int* ext, int tid, int nth) {
  constexpr int es = (int)sizeof(T);
  int rows = 1;
#pragma unroll
  for (int d = 1; d < ND; ++d) rows *= ext[d];
  if (phase < 0) {
    const int n = rows * ext[0];
    for (int i = tid; i < n; i += nth)
      hl_copy_piece(window + (long long)(i / ext[0]) * pitch + i % ext[0],
                    hl_window_src<T, ND>(in, lo, ext, i), es);
    return;
  }
  const int u = in.unit;
  const int row_bytes = ext[0] * es;
  const int head = phase * es;            // bytes before the row's first
  const int nchunk = row_bytes / 16 + 2;  // 16-byte chunks a row can touch
  for (int i = tid; i < rows * nchunk; i += nth) {
    const int r = i / nchunk;
    const int b0 = 16 * (i % nchunk) - head;   // the chunk, from the row
    if (b0 >= row_bytes || b0 + 16 <= 0) continue;
    long long off = lo[0] - in.rmin[0];
    int rr = r;
#pragma unroll
    for (int d = 1; d < ND; ++d) {
      off += (long long)(lo[d] + rr % ext[d] - in.rmin[d]) * in.stride[d];
      rr /= ext[d];
    }
    const char* src = (const char*)((const T*)in.ptr + off);
    char* dst = (char*)(window + (long long)r * pitch);
    for (int b = b0; b < b0 + 16; b += u) {
      if (b >= 0 && b + u <= row_bytes) {
        hl_copy_piece(dst + b, src + b, u);
      } else {
        const int e1 = b + u < row_bytes ? b + u : row_bytes;
        for (int e = b > 0 ? b : 0; e < e1; e += es)
          hl_copy_piece(dst + e, src + e, es);
      }
    }
  }
}
