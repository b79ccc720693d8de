// Kernel B3 in 3D: fold the species-summed tile panels into the interior J.
//
// Replaces the TPU kernel lambdapic_tpu/ops/cellslab.py::fold_reduce_slab
// (:2098, kernel :2165, pallas_call :2228) for 3D rims. Plain PyTorch
// version: lambdapic_torch/ops/cellslab.py::fold_reduce_plain on 3D panels
// (panel overlap-add axis by axis, then parallel/halo.py::halo_reduce with
// a 2-cell guard).
//
// Panels (C, nbx, nby, nbz, T+4, T+4, T+4) come from kernel B2
// (cellstep3d.cu): panel (bi, bj, bk) node (u, v, w) is the current at
// interior index (bi*T + u - 2, bj*T + v - 2, bk*T + w - 2), which runs
// from -2 to n+1 along each axis. One thread per interior output
// (c, i, j, k) pulls every panel node that lands on it: the node itself,
// and on a periodic axis the guard nodes that wrap onto it (i - n and
// i + n); open axes drop their guards. Each index is covered by at most
// two overlapping panels per axis, so up to eight panels per node. No
// atomics: the sum repeats bit for bit. All offsets are 64-bit.
//
// On a device mesh (K5) an axis split over the mesh (I_SPLITX..Z) keeps its
// guard nodes (output n+4 long there, one panel node each) for the
// neighbour exchange and fold.cu's lp_fold_strips, as the 2D fold does.
//
// Bound on an H100 (3.35 TB/s): bytes, the panels read once
// ((T+4)^3 / T^3 = 3.4 values per cell and component at T = 8) and the
// interior J written once.
#include "common.cuh"

namespace {

enum Ptr { P_RIMS, P_OUT, P_COUNT };
enum Int { I_C, I_NX, I_NY, I_NZ, I_TILE, I_PERX, I_PERY, I_PERZ, I_DOUBLE,
           I_SPLITX, I_SPLITY, I_SPLITZ };

// One axis's sources of interior index i: up to six (block, node) pairs,
// from the padded indices i, i - n and i + n that exist (-2..n+1), each
// covered by the panel it starts in and the one before it.
struct Sources {
  int blk[6], node[6], count;
};

__device__ __forceinline__ void add_sources(Sources& s, int padded, int tile,
                                            int nb) {
  int u = padded + 2;                  // >= 0
  for (int b = u / tile - 1; b <= u / tile; ++b) {
    int l = u - b * tile;
    if (b < 0 || b >= nb || l < 0 || l >= tile + 4) continue;
    s.blk[s.count] = b;
    s.node[s.count] = l;
    ++s.count;
  }
}

__device__ __forceinline__ void axis_sources(Sources& s, int i, int n,
                                             bool periodic, bool split,
                                             int tile, int nb) {
  s.count = 0;
  if (split) {                        // output index i is padded index i-2
    add_sources(s, i - 2, tile, nb);
    return;
  }
  add_sources(s, i, tile, nb);
  if (periodic) {
    if (i - n >= -2) add_sources(s, i - n, tile, nb);
    if (i + n <= n + 1) add_sources(s, i + n, tile, nb);
  }
}

template <typename T>
__global__ void fold3(const T* __restrict__ rims, T* __restrict__ out, int C,
                      int nx, int ny, int nz, int tile, int perx, int pery,
                      int perz, int sx, int sy, int sz) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int ox = sx ? nx + 4 : nx, oy = sy ? ny + 4 : ny,
            oz = sz ? nz + 4 : nz;
  const long long ncell = (long long)ox * oy * oz;
  if (idx >= (long long)C * ncell) return;
  int c = (int)(idx / ncell);
  long long rem = idx - (long long)c * ncell;
  int i = (int)(rem / ((long long)oy * oz));
  int r2 = (int)(rem - (long long)i * oy * oz);
  int j = r2 / oz, k = r2 - j * oz;
  const int pan = tile + 4;
  const int nbx = (nx + tile - 1) / tile, nby = (ny + tile - 1) / tile,
            nbz = (nz + tile - 1) / tile;
  Sources srx, sry, srz;
  axis_sources(srx, i, nx, perx, sx, tile, nbx);
  axis_sources(sry, j, ny, pery, sy, tile, nby);
  axis_sources(srz, k, nz, perz, sz, tile, nbz);
  T acc = T(0);
  for (int a = 0; a < srx.count; ++a)
    for (int b = 0; b < sry.count; ++b)
      for (int d = 0; d < srz.count; ++d) {
        long long block =
            (((long long)c * nbx + srx.blk[a]) * nby + sry.blk[b]) * nbz +
            srz.blk[d];
        long long node =
            ((long long)srx.node[a] * pan + sry.node[b]) * pan + srz.node[d];
        acc += rims[block * pan * pan * pan + node];
      }
  out[idx] = acc;
}

template <typename T>
int launch(void** p, const long long* n, cudaStream_t st) {
  int C = (int)n[I_C], nx = (int)n[I_NX], ny = (int)n[I_NY],
      nz = (int)n[I_NZ];
  int sx = (int)n[I_SPLITX], sy = (int)n[I_SPLITY], sz = (int)n[I_SPLITZ];
  long long total = (long long)C * (sx ? nx + 4 : nx) * (sy ? ny + 4 : ny) *
                    (sz ? nz + 4 : nz);
  int threads = 256;
  fold3<T><<<ceil_div(total, threads), threads, 0, st>>>(
      (const T*)p[P_RIMS], (T*)p[P_OUT], C, nx, ny, nz, (int)n[I_TILE],
      (int)n[I_PERX], (int)n[I_PERY], (int)n[I_PERZ], sx, sy, sz);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int; reals unused.
LP_EXPORT int lp_fold_3d(void** ptrs, const long long* ints,
                         const double* reals, void* stream) {
  (void)reals;
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, st);
  return launch<float>(ptrs, ints, st);
}
