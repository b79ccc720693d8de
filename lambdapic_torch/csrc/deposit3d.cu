// Kernel B5 in 3D: the 5-tap (125-node) Esirkepov deposit of one
// re-binned 3D cell species into the padded current (4, nx+2g, ny+2g,
// nz+2g): jx, jy, jz and rho.
//
// Replaces the TPU kernel lambdapic_tpu/ops/cellpallas.py::
// deposit_cell_3d_pallas (:635, kernel :653, pallas_call :736) and its
// XLA fold _fold_xy (:291). Plain PyTorch version: lambdapic_torch/ops/
// cell3d.py::deposit_cell_3d (same contract: home-cell binned slots, dead
// slots carry w = 0).
//
// Two __global__ functions:
//  deposit3d  one block per 8 x 8 x 8 cell tile, one thread per cell: the
//             atomic-free tile deposit of kernel B2 in 3D (cell3d.cuh::
//             deposit_tile) into (4, nbx, nby, nbz, 12, 12, 12) panels;
//             slots with w = 0 add nothing and are skipped;
//  fold_pad3  one thread per padded node: the sum of the (at most two per
//             axis) panel nodes that land on it. Panel (bi, bj, bk) node
//             (a, b, c) is the current at padded index (bi*8 + a - 2 + g,
//             bj*8 + b - 2 + g, bk*8 + c - 2 + g). No atomics: the sum
//             repeats bit for bit.
// The panels' sum runs in another order than the plain version's
// offset-by-offset slice adds, so the two agree to rounding, not bitwise.
//
// Bound on an H100 (3.35 TB/s): bytes: w of every slot, the six other
// reals of the depositing slots read once and the padded current written
// once. The deposit inherits B2's 125 barriers a particle round (a block
// runs as many rounds as its fullest cell has particles).
#include "cell3d.cuh"

namespace {

using lp3d::PAN;
using lp3d::TILE;

enum Ptr { P_X, P_Y, P_Z, P_UX, P_UY, P_UZ, P_IG, P_W, P_PANELS, P_JPAD,
           P_COUNT };
enum Int { I_CAP, I_NX, I_NY, I_NZ, I_G, I_DOUBLE };
// host-computed as the plain version computes them, in double
enum Real { R_CDX, R_CDY, R_CDZ,    // c dt / d per axis
            R_KCD,                  // q / (dx dy dz)
            R_KFX, R_KFY, R_KFZ };  // q / (dy dz dt), q / (dx dz dt),
                                    // q / (dx dy dt)

constexpr int NCOMP = 4;

template <typename T>
__global__ void __launch_bounds__(TILE * TILE * TILE)
    deposit3d(lp3d::DepositIn<T> d) {
  lp3d::deposit_tile(d);
}

template <typename T>
__global__ void fold_pad3(const T* __restrict__ pan, T* __restrict__ out,
                          int nx, int ny, int nz, int g) {
  const long long nxp = nx + 2 * g, nyp = ny + 2 * g, nzp = nz + 2 * g;
  const long long vol = nxp * nyp * nzp;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= NCOMP * vol) return;
  const int c = (int)(idx / vol);
  long long rem = idx - c * vol;
  // panel coordinates: padded index - g + 2
  const int u = (int)(rem / (nyp * nzp)) - g + 2;
  rem %= nyp * nzp;
  const int v = (int)(rem / nzp) - g + 2;
  const int t = (int)(rem % nzp) - g + 2;
  const int nbx = (nx + TILE - 1) / TILE, nby = (ny + TILE - 1) / TILE,
            nbz = (nz + TILE - 1) / TILE;
  T acc = T(0);
  if (u >= 0 && v >= 0 && t >= 0) {
    for (int bi = u / TILE - 1; bi <= u / TILE; ++bi) {
      const int lu = u - bi * TILE;
      if (bi < 0 || bi >= nbx || lu >= PAN) continue;
      for (int bj = v / TILE - 1; bj <= v / TILE; ++bj) {
        const int lv = v - bj * TILE;
        if (bj < 0 || bj >= nby || lv >= PAN) continue;
        for (int bk = t / TILE - 1; bk <= t / TILE; ++bk) {
          const int lt = t - bk * TILE;
          if (bk < 0 || bk >= nbz || lt >= PAN) continue;
          const long long block = ((long long)c * nbx + bi) * nby + bj;
          acc += pan[((block * nbz + bk) * PAN + lu) * PAN * PAN + lv * PAN +
                     lt];
        }
      }
    }
  }
  out[idx] = acc;
}

template <typename T>
int launch(void** p, const long long* n, const double* r, cudaStream_t st) {
  lp3d::DepositIn<T> d;
  d.alive = nullptr;
  d.x = (const T*)p[P_X]; d.y = (const T*)p[P_Y]; d.z = (const T*)p[P_Z];
  d.ux = (const T*)p[P_UX]; d.uy = (const T*)p[P_UY]; d.uz = (const T*)p[P_UZ];
  d.ig = (const T*)p[P_IG]; d.w = (const T*)p[P_W];
  d.rims_in = nullptr;
  d.rims_out = (T*)p[P_PANELS];
  d.cap = (int)n[I_CAP]; d.nx = (int)n[I_NX]; d.ny = (int)n[I_NY];
  d.nz = (int)n[I_NZ];
  d.ncomp = NCOMP;
  d.ncell = (long long)d.nx * d.ny * d.nz;
  d.cd[0] = (T)r[R_CDX]; d.cd[1] = (T)r[R_CDY]; d.cd[2] = (T)r[R_CDZ];
  d.kcd = (T)r[R_KCD];
  d.kf[0] = (T)r[R_KFX]; d.kf[1] = (T)r[R_KFY]; d.kf[2] = (T)r[R_KFZ];
  const int g = (int)n[I_G];
  if (g < 2) return (int)cudaErrorInvalidValue;
  if (d.ncell == 0) return 0;
  dim3 block(TILE, TILE, TILE);
  dim3 grid(ceil_div(d.nz, TILE), ceil_div(d.ny, TILE), ceil_div(d.nx, TILE));
  size_t smem = lp3d::deposit_smem<T>(NCOMP);
  int err = (int)cudaFuncSetAttribute(
      deposit3d<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  deposit3d<T><<<grid, block, smem, st>>>(d);
  err = (int)cudaGetLastError();
  if (err) return err;
  long long total = (long long)NCOMP * (d.nx + 2 * g) * (d.ny + 2 * g) *
                    (d.nz + 2 * g);
  int threads = 256;
  fold_pad3<T><<<ceil_div(total, threads), threads, 0, st>>>(
      (const T*)p[P_PANELS], (T*)p[P_JPAD], d.nx, d.ny, d.nz, g);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int; reals: enum Real (see above).
LP_EXPORT int lp_deposit_3d(void** ptrs, const long long* ints,
                            const double* reals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, reals, st);
  return launch<float>(ptrs, ints, reals, st);
}

LP_EXPORT int lp_deposit_tile() { return lp3d::TILE; }
