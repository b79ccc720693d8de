// Kernel B3: fold the species-summed tile panels into the interior J.
//
// Replaces the TPU kernel lambdapic_tpu/ops/cellslab.py::fold_reduce_slab
// (:2098, kernel :2165, pallas_call :2228). Plain PyTorch version:
// lambdapic_torch/ops/cellslab.py::fold_reduce_plain (panel overlap-add,
// then parallel/halo.py::halo_reduce with a 2-cell guard).
//
// Panels (C, nbx, nby, T+4, T+4) come from kernel B2 (cellstep.cu): panel
// (bi, bj) node (u, v) is the current at interior index
// (bi*T + u - 2, bj*T + v - 2), which runs from -2 to n+1 along each axis.
// One thread per interior output (c, i, j) pulls every panel node that
// lands on it: the node itself, and with a periodic axis the guard nodes
// that wrap onto it (i - n and i + n); open axes drop their guards. Each
// index is covered by at most two overlapping panels per axis. No atomics:
// the sum repeats bit for bit.
//
// Bound on an H100 (3.35 TB/s): bytes. At 1024^2, three components in
// float32 and 16-cell tiles, the panels hold 19.7 MB and the output
// 12.6 MB: 32 MB, about 10 us.
#include "common.cuh"

namespace {

enum Ptr { P_RIMS, P_OUT, P_COUNT };
enum Int { I_C, I_NX, I_NY, I_TILE, I_PERX, I_PERY, I_DOUBLE };

// Candidate padded indices u (interior index -2..n+1) that fold onto
// interior index i along one axis.
__device__ __forceinline__ int sources(int i, int n, bool periodic, int* u) {
  int k = 0;
  u[k++] = i;
  if (periodic) {
    if (i - n >= -2) u[k++] = i - n;
    if (i + n <= n + 1) u[k++] = i + n;
  }
  return k;
}

template <typename T>
__global__ void fold(const T* __restrict__ rims, T* __restrict__ out, int C,
                     int nx, int ny, int tile, int perx, int pery) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)C * nx * ny;
  if (idx >= total) return;
  int c = (int)(idx / ((long long)nx * ny));
  int rem = (int)(idx % ((long long)nx * ny));
  int i = rem / ny, j = rem % ny;
  const int pan = tile + 4;
  const int nbx = (nx + tile - 1) / tile, nby = (ny + tile - 1) / tile;
  int us[3], vs[3];
  int nu = sources(i, nx, perx, us), nv = sources(j, ny, pery, vs);
  T acc = T(0);
  for (int a = 0; a < nu; ++a) {
    int u = us[a] + 2;                 // >= 0
    for (int bi = u / tile - 1; bi <= u / tile; ++bi) {
      int lu = u - bi * tile;
      if (bi < 0 || bi >= nbx || lu < 0 || lu >= pan) continue;
      for (int b = 0; b < nv; ++b) {
        int v = vs[b] + 2;
        for (int bj = v / tile - 1; bj <= v / tile; ++bj) {
          int lv = v - bj * tile;
          if (bj < 0 || bj >= nby || lv < 0 || lv >= pan) continue;
          acc += rims[((((long long)c * nbx + bi) * nby + bj) * pan + lu) * pan + lv];
        }
      }
    }
  }
  out[idx] = acc;
}

template <typename T>
int launch(void** p, const long long* n, cudaStream_t st) {
  int C = (int)n[I_C], nx = (int)n[I_NX], ny = (int)n[I_NY];
  long long total = (long long)C * nx * ny;
  int threads = 256;
  fold<T><<<ceil_div(total, threads), threads, 0, st>>>(
      (const T*)p[P_RIMS], (T*)p[P_OUT], C, nx, ny, (int)n[I_TILE],
      (int)n[I_PERX], (int)n[I_PERY]);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int; reals unused.
LP_EXPORT int lp_fold(void** ptrs, const long long* ints, const double* reals,
                      void* stream) {
  (void)reals;
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, st);
  return launch<float>(ptrs, ints, st);
}
