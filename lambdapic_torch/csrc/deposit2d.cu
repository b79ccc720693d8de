// Kernel B5: the 5-tap Esirkepov deposit of one re-binned 2D cell species
// into the padded current (4, nx+2g, ny+2g): jx, jy, jz and rho.
//
// Replaces the TPU kernel lambdapic_tpu/ops/cellpallas.py::
// deposit_cell_2d_pallas (:420, kernel :437, pallas_call :513) and its
// XLA fold _fold_xy (:291). Plain PyTorch version: lambdapic_torch/ops/
// cell2d.py::deposit_cell_2d (same contract: home-cell binned slots, dead
// slots carry w = 0).
//
// Alive mask (P_ALIVE, uint8, required): only alive slots deposit, and no
// dead slot's payload is read.
//
// Two __global__ functions:
//  deposit   one block per 16 x 16 cell tile: the tile deposit of kernel
//            B2's deposit2 (cell2d.cuh::deposit_panel), so the two sum
//            each tile in one order. Each thread reads its cell's alive
//            bytes (64 slots to a bit mask); a tile with no alive slot
//            writes its flag 0 and no panel. Otherwise each thread walks
//            its cell's alive slots once, computing each particle's shapes
//            once into 25 per-offset sums in registers; the offsets go
//            into a shared (4, 20, 20) panel one after another with a
//            barrier between (no atomics), the panel to (4, nbx, nby, 20,
//            20) and the tile's flag 1;
//  fold_pad  one thread per padded node, a block row per padded row: the
//            sum of the (at most two per axis) panel nodes of flagged
//            tiles that land on it, zero where none does, so the padded
//            current is written once and only the flagged tiles' panels
//            are read. Panel (bi, bj) node (a, b) is the current at padded
//            index (bi*16 + a - 2 + g, bj*16 + b - 2 + g). No atomics: the
//            sum repeats bit for bit.
// The panels' sum runs in another order than the plain version's
// offset-by-offset slice adds, so the two agree to rounding, not bitwise.
//
// Bound on an H100 (3.35 TB/s): bytes: the mask, seven reals of each alive
// slot read once and the padded current written once. What holds the
// design: where most tiles are empty (the 2D slice's foil fills 6% of its
// cells) the mask reads of every tile and the write of J; in the occupied
// tiles each thread's walk of its cell's particles, a chain of dependent
// sums, then the 25 barriers of the panel adds.
#include "cell2d.cuh"

namespace {

using namespace lp2d;

enum Ptr { P_X, P_Y, P_UX, P_UY, P_UZ, P_IG, P_W, P_PANELS, P_JPAD, P_ALIVE,
           P_FLAGS, P_COUNT };
enum Int { I_CAP, I_NX, I_NY, I_G, I_DOUBLE };
// host-computed as the plain version computes them, in double
enum Real { R_CDX, R_CDY,           // c dt / dx, c dt / dy
            R_C,                    // c
            R_KCD, R_KFX, R_KFY };  // q / (dx dy), q / (dy dt), q / (dx dt)

constexpr int NCOMP = 4;

template <typename T>
__global__ void __launch_bounds__(TILE * TILE, 2)
    deposit(DepositIn<T> d, unsigned char* __restrict__ flags) {
  const bool any = deposit_panel<T, NCOMP, false>(d, true);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    flags[(long long)blockIdx.y * gridDim.x + blockIdx.x] = any;
}

// One block row of threads per padded row (component c = blockIdx.z,
// padded x index blockIdx.y, then every gridDim.y-th row, as gridDim.y
// is capped at 65535), threads along padded y.
template <typename T>
__global__ void fold_pad(const T* __restrict__ pan,
                         const unsigned char* __restrict__ flags,
                         T* __restrict__ out, int nx, int ny, int g) {
  const int nxp = nx + 2 * g, nyp = ny + 2 * g;
  const int c = blockIdx.z;
  const int py = blockIdx.x * blockDim.x + threadIdx.x;
  if (py >= nyp) return;
  const int nbx = (nx + TILE - 1) / TILE, nby = (ny + TILE - 1) / TILE;
  // panel coordinates: padded index - g + 2
  const int v = py - g + 2;
  for (int px = blockIdx.y; px < nxp; px += gridDim.y) {
    const int u = px - g + 2;
    T acc = T(0);
    if (u >= 0 && v >= 0) {
      for (int bi = u / TILE - 1; bi <= u / TILE; ++bi) {
        const int lu = u - bi * TILE;
        if (bi < 0 || bi >= nbx || lu >= PAN) continue;
        for (int bj = v / TILE - 1; bj <= v / TILE; ++bj) {
          const int lv = v - bj * TILE;
          if (bj < 0 || bj >= nby || lv >= PAN) continue;
          if (!flags[bi * nby + bj]) continue;
          acc += pan[((((long long)c * nbx + bi) * nby + bj) * PAN + lu) * PAN + lv];
        }
      }
    }
    out[((long long)c * nxp + px) * nyp + py] = acc;
  }
}

template <typename T>
int launch(void** p, const long long* n, const double* r, cudaStream_t st) {
  DepositIn<T> d;
  d.alive = (const unsigned char*)p[P_ALIVE];
  d.x = (const T*)p[P_X]; d.y = (const T*)p[P_Y];
  d.ux = (const T*)p[P_UX]; d.uy = (const T*)p[P_UY]; d.uz = (const T*)p[P_UZ];
  d.ig = (const T*)p[P_IG]; d.w = (const T*)p[P_W];
  d.rims_in = nullptr;
  d.rims_out = (T*)p[P_PANELS];
  d.cap = (int)n[I_CAP]; d.nx = (int)n[I_NX]; d.ny = (int)n[I_NY];
  d.ncell = (long long)d.nx * d.ny;
  d.cdx = (T)r[R_CDX]; d.cdy = (T)r[R_CDY]; d.c = (T)r[R_C];
  d.kcd = (T)r[R_KCD]; d.kfx = (T)r[R_KFX]; d.kfy = (T)r[R_KFY];
  unsigned char* flags = (unsigned char*)p[P_FLAGS];
  const int g = (int)n[I_G];
  if (g < 2 || d.cap < 0 || !d.alive || !flags)
    return (int)cudaErrorInvalidValue;
  dim3 block(TILE, TILE);
  dim3 grid(ceil_div(d.ny, TILE), ceil_div(d.nx, TILE));
  size_t smem = sizeof(T) * NCOMP * PAN * PAN;
  deposit<T><<<grid, block, smem, st>>>(d, flags);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int threads = 128;
  dim3 rows(ceil_div(d.ny + 2 * g, threads), min(d.nx + 2 * g, 65535),
            NCOMP);
  fold_pad<T><<<rows, threads, 0, st>>>((const T*)p[P_PANELS], flags,
                                        (T*)p[P_JPAD], d.nx, d.ny, g);
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
