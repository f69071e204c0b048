// Fixed helpers of the stage kernel (ops/stage_kernel.py).
//
// ops/stage_kernel.py emits, for each untiled whole-array stage, its point
// function (the stencil-group kernel's emitter: group_kernel.cuh's
// arithmetic, casts and intrinsics), the walk of one thread's outputs and
// the kernel; this header adds the store of a thread's V outputs: one
// 16-, 8- or 4-byte store on the card where they fill one, else one store
// each. The host build (CPU tests) copies them.
#pragma once

#include "group_kernel.cuh"

template <typename T, int V>
HL_FN void hl_store(T* dst, const T* v) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) * V == 16) {
    uint4 u;
    memcpy(&u, v, 16);
    *(uint4*)dst = u;
  } else if constexpr (sizeof(T) * V == 8) {
    uint2 u;
    memcpy(&u, v, 8);
    *(uint2*)dst = u;
  } else if constexpr (sizeof(T) * V == 4) {
    unsigned u;
    memcpy(&u, v, 4);
    *(unsigned*)dst = u;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) dst[k] = v[k];
  }
#else
  memcpy((void*)dst, (const void*)v, sizeof(T) * V);
#endif
}
