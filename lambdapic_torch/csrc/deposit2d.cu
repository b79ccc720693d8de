// Kernel B5: the 5-tap Esirkepov deposit of one re-binned 2D cell species
// into the padded current (4, nx+2g, ny+2g): jx, jy, jz and rho.
//
// Replaces the TPU kernel lambdapic_tpu/ops/cellpallas.py::
// deposit_cell_2d_pallas (:420, kernel :437, pallas_call :513) and its
// XLA fold _fold_xy (:291). Plain PyTorch version: lambdapic_torch/ops/
// cell2d.py::deposit_cell_2d (same contract: home-cell binned slots, dead
// slots carry w = 0).
//
// Two __global__ functions:
//  deposit   one block per 16 x 16 cell tile, the atomic-free tile deposit
//            of kernel B2 (cell2d.cuh::deposit_tile) into (4, nbx, nby,
//            20, 20) panels; slots with w = 0 add nothing and are skipped;
//  fold_pad  one thread per padded node: the sum of the (at most two per
//            axis) panel nodes that land on it. Panel (bi, bj) node (a, b)
//            is the current at padded index (bi*16 + a - 2 + g,
//            bj*16 + b - 2 + g). No atomics: the sum repeats bit for bit.
// The panels' sum runs in another order than the plain version's
// offset-by-offset slice adds, so the two agree to rounding, not bitwise.
//
// Bound on an H100 (3.35 TB/s): bytes: seven reals a slot read once and
// the padded current written once.
#include "cell2d.cuh"

namespace {

using namespace lp2d;

enum Ptr { P_X, P_Y, P_UX, P_UY, P_UZ, P_IG, P_W, P_PANELS, P_JPAD, P_COUNT };
enum Int { I_CAP, I_NX, I_NY, I_G, I_DOUBLE };
// host-computed as the plain version computes them, in double
enum Real { R_CDX, R_CDY,           // c dt / dx, c dt / dy
            R_C,                    // c
            R_KCD, R_KFX, R_KFY };  // q / (dx dy), q / (dy dt), q / (dx dt)

constexpr int NCOMP = 4;

template <typename T>
__global__ void __launch_bounds__(TILE * TILE) deposit(DepositIn<T> d) {
  deposit_tile(d);
}

template <typename T>
__global__ void fold_pad(const T* __restrict__ pan, T* __restrict__ out,
                         int nx, int ny, int g) {
  const int nxp = nx + 2 * g, nyp = ny + 2 * g;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)NCOMP * nxp * nyp;
  if (idx >= total) return;
  int c = (int)(idx / ((long long)nxp * nyp));
  int rem = (int)(idx % ((long long)nxp * nyp));
  // panel coordinates: padded index - g + 2
  int u = rem / nyp - g + 2, v = rem % nyp - g + 2;
  const int nbx = (nx + TILE - 1) / TILE, nby = (ny + TILE - 1) / TILE;
  T acc = T(0);
  if (u >= 0 && v >= 0) {
    for (int bi = u / TILE - 1; bi <= u / TILE; ++bi) {
      int lu = u - bi * TILE;
      if (bi < 0 || bi >= nbx || lu >= PAN) continue;
      for (int bj = v / TILE - 1; bj <= v / TILE; ++bj) {
        int lv = v - bj * TILE;
        if (bj < 0 || bj >= nby || lv >= PAN) continue;
        acc += pan[((((long long)c * nbx + bi) * nby + bj) * PAN + lu) * PAN + lv];
      }
    }
  }
  out[idx] = acc;
}

template <typename T>
int launch(void** p, const long long* n, const double* r, cudaStream_t st) {
  DepositIn<T> d;
  d.alive = nullptr;
  d.x = (const T*)p[P_X]; d.y = (const T*)p[P_Y];
  d.ux = (const T*)p[P_UX]; d.uy = (const T*)p[P_UY]; d.uz = (const T*)p[P_UZ];
  d.ig = (const T*)p[P_IG]; d.w = (const T*)p[P_W];
  d.rims_in = nullptr;
  d.rims_out = (T*)p[P_PANELS];
  d.cap = (int)n[I_CAP]; d.nx = (int)n[I_NX]; d.ny = (int)n[I_NY];
  d.ncomp = NCOMP;
  d.ncell = (long long)d.nx * d.ny;
  d.cdx = (T)r[R_CDX]; d.cdy = (T)r[R_CDY]; d.c = (T)r[R_C];
  d.kcd = (T)r[R_KCD]; d.kfx = (T)r[R_KFX]; d.kfy = (T)r[R_KFY];
  const int g = (int)n[I_G];
  if (g < 2) return (int)cudaErrorInvalidValue;
  dim3 block(TILE, TILE);
  dim3 grid(ceil_div(d.ny, TILE), ceil_div(d.nx, TILE));
  size_t smem = sizeof(T) * NCOMP * PAN * PAN;
  deposit<T><<<grid, block, smem, st>>>(d);
  int err = (int)cudaGetLastError();
  if (err) return err;
  long long total = (long long)NCOMP * (d.nx + 2 * g) * (d.ny + 2 * g);
  int threads = 256;
  fold_pad<T><<<ceil_div(total, threads), threads, 0, st>>>(
      (const T*)p[P_PANELS], (T*)p[P_JPAD], d.nx, d.ny, g);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int; reals: enum Real (see above).
LP_EXPORT int lp_deposit_2d(void** ptrs, const long long* ints,
                            const double* reals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, reals, st);
  return launch<float>(ptrs, ints, reals, st);
}

LP_EXPORT int lp_deposit_tile() { return lp2d::TILE; }
