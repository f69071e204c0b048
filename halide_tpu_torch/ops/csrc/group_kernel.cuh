// Fixed helpers of the stencil-group kernel (ops/group_kernel.py).
//
// ops/group_kernel.py emits one .cu per stencil group that holds only the
// member Funcs' point expressions and their footprint arithmetic, and
// includes this header for everything else:
//   - the reference's integer semantics: floor division and floor modulo
//     with x/0 == x%0 == 0, and wrapping arithmetic at every width
//     (u16/u32 included), computed through a wider unsigned type so that
//     no signed overflow (undefined in C++) can occur;
//   - Halide casts (float -> int truncates toward zero, then wraps);
//   - the shift-inwards origin of the last tile (Schedule.h ShiftInwards);
//   - staging of a halo'd window of an input into shared memory, edge-
//     replicated where the window leaves the realized region, either with
//     plain loads or, for the band walk's next sub-tile, by cp.async ahead
//     of the compute (4- and 8-byte elements: cp.async moves 4, 8 or 16
//     bytes).
//
// Every helper is __host__ __device__ so that the emitted point functions
// also compile with a host C++ compiler, where the CUDA qualifiers below
// are defined empty (the CPU tests compare them with the plain version).
#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __global__
#endif

#define HL_FN __host__ __device__ inline

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

// Shifts by a count outside [0, bits) give 0 (or the sign for a right
// shift of a negative value), as XLA's shifts do.
template <typename T>
HL_FN T hl_shl(T a, T b) {
  constexpr int bits = 8 * (int)sizeof(T);
  if (b < 0 || (long long)b >= bits) return (T)0;
  return (T)((hl_wide_u<T>)a << (int)b);
}

template <typename T>
HL_FN T hl_shr(T a, T b) {
  constexpr int bits = 8 * (int)sizeof(T);
  if (b < 0 || (long long)b >= bits) {
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
// then wraps into the destination width; integer narrowing wraps.
template <typename To, typename From>
HL_FN To hl_cast(From v) {
  if constexpr (std::is_same<To, bool>::value) {
    return v != (From)0;
  } else if constexpr (std::is_floating_point<To>::value) {
    return (To)v;
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

// --- tiling -------------------------------------------------------------------

// Origin of tile `t` of size `tile` over [mn, mn + ext): the last tile is
// shifted inwards to end at the extent, so that no read leaves the
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
template <int ND>
struct HlInput {
  const void* ptr;
  long long stride[ND];
  int rmin[ND];
  int rsize[ND];
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

// Stage window[i] = input[clamp(lo + coords(i))] for i in [first, n) with
// step `step`; coords(i) walks `ext` with dim 0 fastest. Coordinates
// outside the realized region replicate its edge (repeat_edge semantics:
// the clamps stripped from the point expressions are restored here).
template <typename T, int ND>
HL_FN void hl_stage_window(T* window, const HlInput<ND>& in, const int* lo,
                           const int* ext, int first, int step) {
  int n = 1;
  for (int d = 0; d < ND; ++d) n *= ext[d];
  for (int i = first; i < n; i += step)
    window[i] = *hl_window_src<T, ND>(in, lo, ext, i);
}

// --- the band walk's staging of the next sub-tile's windows ------------------

// A block barrier on the card; the host build runs one thread a block.
HL_FN void hl_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

// cp.async route (4- and 8-byte elements): each element is copied into
// shared memory without passing through registers, and the thread goes on
// to compute; hl_async_wait() then waits for its own copies (the barrier
// after it makes every thread's visible). The host build copies at once.
template <typename T, int ND>
HL_FN void hl_stage_window_async(T* window, const HlInput<ND>& in,
                                 const int* lo, const int* ext, int first,
                                 int step) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async moves 4 or 8");
  int n = 1;
  for (int d = 0; d < ND; ++d) n *= ext[d];
  for (int i = first; i < n; i += step) {
    const T* src = hl_window_src<T, ND>(in, lo, ext, i);
#ifdef __CUDA_ARCH__
    const unsigned dst = (unsigned)__cvta_generic_to_shared(window + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(src), "n"((int)sizeof(T)));
#else
    window[i] = *src;
#endif
  }
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

HL_FN void hl_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}
