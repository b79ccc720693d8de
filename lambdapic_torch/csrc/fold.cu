// Kernel B3 in 2D: fold the species-summed tile panels into the interior
// J (the 3D form is fold3d.cu).
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
// On a device mesh (K5: the cross-device form, replacing fold_reduce_slab's
// strip ppermutes, cellslab.py:2135-2153) an axis split over the mesh
// (I_SPLITX, I_SPLITY) keeps its two guard nodes per side: the output is
// n+4 long there (padded index -2..n+1, one panel node each), while the
// unsplit axes wrap or drop in place as above. The caller then sends the
// guard strips to the neighbour shards and lp_fold_strips adds what it
// receives into the interior, one launch per split axis in reverse axis
// order: parallel/halo.py::halo_reduce's order, so a corner node reaches
// the diagonal neighbour through two exchanges.
//
// Bound on an H100 (3.35 TB/s): bytes. At 1024^2, three components in
// float32 and 16-cell tiles, the panels hold 19.7 MB and the output
// 12.6 MB: 32 MB, about 10 us.
#include "common.cuh"

namespace {

enum Ptr { P_RIMS, P_OUT, P_COUNT };
enum Int { I_C, I_NX, I_NY, I_TILE, I_PERX, I_PERY, I_DOUBLE, I_SPLITX,
           I_SPLITY };
enum StripPtr { S_IN, S_LO, S_HI, S_OUT };
enum StripInt { S_OUTER, S_N, S_INNER, S_DOUBLE };

// Candidate padded indices u (interior index -2..n+1) that fold onto
// output index i along one axis: on a split axis the one node i - 2.
__device__ __forceinline__ int sources(int i, int n, bool periodic,
                                       bool split, int* u) {
  int k = 0;
  if (split) {
    u[k++] = i - 2;
    return k;
  }
  u[k++] = i;
  if (periodic) {
    if (i - n >= -2) u[k++] = i - n;
    if (i + n <= n + 1) u[k++] = i + n;
  }
  return k;
}

template <typename T>
__global__ void fold(const T* __restrict__ rims, T* __restrict__ out, int C,
                     int nx, int ny, int tile, int perx, int pery, int splitx,
                     int splity) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int ox = splitx ? nx + 4 : nx, oy = splity ? ny + 4 : ny;
  long long total = (long long)C * ox * oy;
  if (idx >= total) return;
  int c = (int)(idx / ((long long)ox * oy));
  int rem = (int)(idx % ((long long)ox * oy));
  int i = rem / oy, j = rem % oy;
  const int pan = tile + 4;
  const int nbx = (nx + tile - 1) / tile, nby = (ny + tile - 1) / tile;
  int us[3], vs[3];
  int nu = sources(i, nx, perx, splitx, us),
      nv = sources(j, ny, pery, splity, vs);
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
  int sx = (int)n[I_SPLITX], sy = (int)n[I_SPLITY];
  long long total = (long long)C * (sx ? nx + 4 : nx) * (sy ? ny + 4 : ny);
  int threads = 256;
  fold<T><<<ceil_div(total, threads), threads, 0, st>>>(
      (const T*)p[P_RIMS], (T*)p[P_OUT], C, nx, ny, (int)n[I_TILE],
      (int)n[I_PERX], (int)n[I_PERY], sx, sy);
  return (int)cudaGetLastError();
}

// The strip add of one split axis, the array seen as (outer, n+4, inner):
// out (outer, n, inner) = the interior rows 2..n+1, plus on rows 0, 1 the
// strip received from the lower neighbour (its guard rows n+2, n+3) and on
// rows n-2, n-1 the one from the upper neighbour (its rows 0, 1), each
// (outer, 2, inner), added in halo_reduce's order (interior + lo + hi).
template <typename T>
__global__ void strips(const T* __restrict__ in, const T* __restrict__ lo,
                       const T* __restrict__ hi, T* __restrict__ out,
                       long long outer, int n, long long inner) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= outer * n * inner) return;
  long long o = idx / ((long long)n * inner);
  long long r = idx - o * n * inner;
  int i = (int)(r / inner);
  long long k = r - (long long)i * inner;
  T v = in[(o * (n + 4) + i + 2) * inner + k];
  v = v + (i < 2 ? lo[(o * 2 + i) * inner + k] : T(0));
  v = v + (i >= n - 2 ? hi[(o * 2 + i - (n - 2)) * inner + k] : T(0));
  out[idx] = v;
}

template <typename T>
int launch_strips(void** p, const long long* n, cudaStream_t st) {
  long long outer = n[S_OUTER], inner = n[S_INNER];
  int len = (int)n[S_N];
  if (len < 2) return (int)cudaErrorInvalidValue;
  long long total = outer * len * inner;
  int threads = 256;
  strips<T><<<ceil_div(total, threads), threads, 0, st>>>(
      (const T*)p[S_IN], (const T*)p[S_LO], (const T*)p[S_HI], (T*)p[S_OUT],
      outer, len, inner);
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

// ptrs: enum StripPtr; ints: enum StripInt; reals unused. For the 2D
// panels (3D meshes add their strips in fold3d.cu's fold).
LP_EXPORT int lp_fold_strips(void** ptrs, const long long* ints,
                             const double* reals, void* stream) {
  (void)reals;
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[S_DOUBLE]) return launch_strips<double>(ptrs, ints, st);
  return launch_strips<float>(ptrs, ints, st);
}
