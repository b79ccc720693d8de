// Shared helpers for the port's CUDA kernels (lambdapic_torch/csrc).
//
// Every library exports C functions of one shape:
//     int fn(void** ptrs, const long long* ints, const double* reals,
//            cudaStream_t stream)
// returning cudaGetLastError() after its launches. The index of each
// pointer, integer and real in those arrays is listed beside the
// function and mirrored by its Python wrapper.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LP_EXPORT extern "C" __attribute__((visibility("default")))

// Quadratic B-spline weight M2(d) (ops/cell2d.py::_m2), written as the
// plain version evaluates it.
template <typename T>
__device__ __forceinline__ T m2(T d) {
  T ad = fabs(d);
  if (ad <= T(0.5)) return T(0.75) - d * d;
  if (ad < T(1.5)) {
    T t = T(1.5) - ad;
    return T(0.5) * (t * t);
  }
  return T(0);
}

__host__ __device__ inline int wrap_index(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }
