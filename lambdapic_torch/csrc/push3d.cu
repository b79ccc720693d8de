// Kernel B4 in 3D: gather, Boris and half push of a freshly re-binned 3D
// cell species, with the six gathered components on request (want_eb).
//
// Replaces the TPU kernel lambdapic_tpu/ops/cellpallas.py::
// fused_push_cell_3d (:523, kernel :546, pallas_call :630). Plain PyTorch
// version: lambdapic_torch/ops/cellpallas.py::fused_push_cell_3d_plain,
// i.e. [a first half push at inv_gamma = 1/sqrt(1 + u^2)] ->
// gather_cell_3d -> boris_push -> push_position_3d, with the dead slots'
// values put in at the end.
//
// push3d (one __global__): one 256-thread block per 8^3 tile of cells
// (tile (bi, bj, bk) = block (bi*nby + bj)*nbz + bk). The block copies the
// tile's E/B window (six components of 11^3 nodes, cells -2 .. +8 of each
// axis: 31.9 KB in float32, 63.9 KB in float64) into shared memory with
// cp.async (cell3d.cuh::load_window). It then takes the tile's slots one
// slot index at a time (a round of 512 cells): it lists the round's alive
// slots in cell order (a warp ballot and the warps' counts) while the
// copy flies, and each thread takes one listed particle: the optional
// first half push, the gather from the shared window
// (cell3d.cuh::gather_eb_window, the taps and order of B2's tile kernel,
// so the two gather alike bit for bit), Boris (cell2d.cuh::boris) and the
// second half push, its 7 (13 with want_eb) outputs kept in a shared
// stage. Last, every slot of the round is written once, neighbouring
// threads on neighbouring cells: the stage's values into the alive slots,
// the dead values into the others. Indices inside the tile are 32-bit;
// only slot offsets are 64-bit.
//
// Alive mask (P_ALIVE, uint8, required): only alive slots are pushed, and
// a dead slot gets B2's dead values: zero floats, inv_gamma 1 and, with
// want_eb, zero fields; the ids are not B4's. What reads a dead slot's
// outputs downstream: the next step's first half push (a zero move), the
// exact re-binning (ops/cell2d.py::migrate_cells keys and moves alive
// slots only), QED's update_chi_and_events (its draws and events are
// masked by alive) and B5 (the mask; the plain version's w = 0);
// tests/test_torch_deadslots3d.py holds the per-stage 3D step to that.
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s float32): bytes: the mask, six
// reals of each alive slot read, seven (thirteen with want_eb) reals of
// every slot written, and the E/B nodes once. Operations: about 970 a
// particle (21 spline weights, six gathers of 36-48 taps, Boris, two half
// pushes). What the design does about it: the gather reads shared memory
// (the old one-thread-a-slot kernel read 252 taps a slot from the padded
// fields in device memory, for dead slots too); a dead slot costs its
// stores and no arithmetic; every store covers whole 32-byte sectors (the
// alive slots' results go out with their dead neighbours', so no sector
// is written in parts at two times); the fields are read once a tile
// window (11^3 / 8^3 = 2.6 times the interior, mostly from L2). A round's
// last pass of particles is partly idle (at most one pass in each).
// Compiled with --fmad=false, so an alive slot is bitwise the plain
// version's.
#include "cell3d.cuh"

namespace {

using lp2d::pushed;
using lp3d::TILE;
using lp3d::TILE3;
using lp3d::WIN3;

enum Ptr { P_EB, P_X, P_Y, P_Z, P_UX, P_UY, P_UZ,
           P_OX, P_OY, P_OZ, P_OUX, P_OUY, P_OUZ, P_OIG, P_OEB,
           P_ALIVE = P_OEB + 6, P_COUNT };
enum Int { I_CAP, I_NX, I_NY, I_NZ, I_G, I_WANT_EB, I_DO_POS1, I_DOUBLE };
// host-computed as the plain version computes them, in double
enum Real { R_HX, R_HY, R_HZ,   // c dt / d / 2 per axis
            R_EF, R_BF };       // q dt / (2 m c), q dt / (2 m)

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROUND = TILE3;          // one slot index of the tile a round
constexpr int PER_THREAD = ROUND / THREADS;
constexpr int NOUT = 13;              // outputs: x y z ux uy uz ig, 6 fields

template <typename T>
struct Args {
  const T* eb;
  const unsigned char* alive;
  const T *x, *y, *z, *ux, *uy, *uz;
  T* out[NOUT];                 // x y z ux uy uz inv_gamma [ex .. bz]
  int cap, nx, ny, nz, g, nout, do_pos1;
  long long ncell;
  T h[3], ef, bf;
};

// Dynamic shared memory of a block: the E/B window, the round's outputs
// (nout arrays of ROUND), the list of its alive candidates and the warps'
// counts. float32: 60.5 KB with want_eb (three blocks an SM), 48.2 KB
// without.
template <typename T>
inline size_t push_smem(int nout) {
  return sizeof(T) * (6 * WIN3 + (size_t)nout * ROUND) +
         sizeof(int) * (ROUND + PER_THREAD * WARPS);
}

// One listed particle, slot idx of the tile's cell (lx, ly, lz) at
// (ix, iy, iz): its outputs into stage[k * ROUND + li].
template <typename T>
__device__ __forceinline__ void push_one(const Args<T>& a, const T* win,
                                         T* stage, int li, long long idx,
                                         int lx, int ly, int lz, int ix,
                                         int iy, int iz) {
  T x = a.x[idx], y = a.y[idx], z = a.z[idx];
  T ux = a.ux[idx], uy = a.uy[idx], uz = a.uz[idx];
  if (a.do_pos1) {
    T ig0 = T(1) / sqrt(((T(1) + ux * ux) + uy * uy) + uz * uz);
    x = pushed(x, ux, ig0, a.h[0]);
    y = pushed(y, uy, ig0, a.h[1]);
    z = pushed(z, uz, ig0, a.h[2]);
  }
  const T d[3] = {x - T(ix), y - T(iy), z - T(iz)};
  T e[6];
  lp3d::gather_eb_window(win, lx, ly, lz, d, e);
  T ig = lp2d::boris(ux, uy, uz, e, a.ef, a.bf);
  T* o = stage + li;
  o[0 * ROUND] = pushed(x, ux, ig, a.h[0]);
  o[1 * ROUND] = pushed(y, uy, ig, a.h[1]);
  o[2 * ROUND] = pushed(z, uz, ig, a.h[2]);
  o[3 * ROUND] = ux;
  o[4 * ROUND] = uy;
  o[5 * ROUND] = uz;
  o[6 * ROUND] = ig;
  if (a.nout == NOUT) {
#pragma unroll
    for (int k = 0; k < 6; ++k) o[(7 + k) * ROUND] = e[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 3) push3d(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  T* stage = win + 6 * WIN3;
  int* list = reinterpret_cast<int*>(stage + a.nout * ROUND);
  int* wcnt = list + ROUND;               // (PER_THREAD, WARPS)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nby = (a.ny + TILE - 1) / TILE, nbz = (a.nz + TILE - 1) / TILE;
  const int block = blockIdx.x;
  const int bi = block / (nby * nbz), rb = block - bi * nby * nbz;
  const int bj = rb / nbz, bk = rb - bj * nbz;
  const int x0 = bi * TILE, y0 = bj * TILE, z0 = bk * TILE;
  lp3d::load_window(win, a.eb, a.nx, a.ny, a.nz, a.g, x0, y0, z0, tid,
                    THREADS);
  lp3d::copy_async_commit();
  // this thread's candidates li = r * THREADS + tid of a round (the same
  // cells every round): neighbouring threads on neighbouring cells along
  // z, so each store of a round covers whole rows of the tile
  long long cell[PER_THREAD];
  bool in[PER_THREAD];
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const int li = r * THREADS + tid;
    const int ix = x0 + (li >> 6), iy = y0 + ((li >> 3) & 7),
              iz = z0 + (li & 7);
    in[r] = ix < a.nx && iy < a.ny && iz < a.nz;
    cell[r] = ((long long)ix * a.ny + iy) * a.nz + iz;
  }
  for (int sl = 0; sl < a.cap; ++sl) {
    // list the round's alive candidates in candidate order
    const long long s0 = (long long)sl * a.ncell;
    bool live[PER_THREAD];
    unsigned below[PER_THREAD];
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      live[r] = in[r] && a.alive[s0 + cell[r]];
      const unsigned b = __ballot_sync(0xffffffffu, live[r]);
      below[r] = __popc(b & ((1u << lane) - 1u));
      if (lane == 0) wcnt[r * WARPS + warp] = __popc(b);
    }
    if (sl == 0) lp3d::copy_async_wait();
    __syncthreads();
    int n = 0;
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      int before = 0, tot = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int t = wcnt[r * WARPS + w];
        before += w < warp ? t : 0;
        tot += t;
      }
      if (live[r]) list[n + before + below[r]] = r * THREADS + tid;
      n += tot;
    }
    __syncthreads();
    // push the listed particles, outputs into the stage
    for (int j = tid; j < n; j += THREADS) {
      const int li = list[j];
      const int lx = li >> 6, ly = (li >> 3) & 7, lz = li & 7;
      const int ix = x0 + lx, iy = y0 + ly, iz = z0 + lz;
      push_one(a, win, stage, li, s0 + ((long long)ix * a.ny + iy) * a.nz + iz,
               lx, ly, lz, ix, iy, iz);
    }
    __syncthreads();
    // every slot of the round written once, coalesced: the stage's values
    // into the alive slots, the dead values (0, inv_gamma 1) into the rest
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      if (!in[r]) continue;
      const long long idx = s0 + cell[r];
      const int li = r * THREADS + tid;
      for (int k = 0; k < a.nout; ++k)
        a.out[k][idx] = live[r] ? stage[k * ROUND + li] : T(k == 6 ? 1 : 0);
    }
  }
}

template <typename T>
int launch(void** p, const long long* n, const double* r, cudaStream_t st) {
  Args<T> a;
  a.eb = (const T*)p[P_EB];
  a.alive = (const unsigned char*)p[P_ALIVE];
  a.x = (const T*)p[P_X]; a.y = (const T*)p[P_Y]; a.z = (const T*)p[P_Z];
  a.ux = (const T*)p[P_UX]; a.uy = (const T*)p[P_UY]; a.uz = (const T*)p[P_UZ];
  for (int k = 0; k < NOUT; ++k) a.out[k] = (T*)p[P_OX + k];
  a.cap = (int)n[I_CAP]; a.nx = (int)n[I_NX]; a.ny = (int)n[I_NY];
  a.nz = (int)n[I_NZ]; a.g = (int)n[I_G];
  a.nout = n[I_WANT_EB] ? NOUT : 7;
  a.do_pos1 = (int)n[I_DO_POS1];
  a.ncell = (long long)a.nx * a.ny * a.nz;
  a.h[0] = (T)r[R_HX]; a.h[1] = (T)r[R_HY]; a.h[2] = (T)r[R_HZ];
  a.ef = (T)r[R_EF]; a.bf = (T)r[R_BF];
  if (a.g < 2 || a.cap < 0 || !a.alive) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < a.nout; ++k)
    if (!a.out[k]) return (int)cudaErrorInvalidValue;
  if (a.ncell == 0 || a.cap == 0) return 0;
  const int nblocks = ceil_div(a.nx, TILE) * ceil_div(a.ny, TILE) *
                      ceil_div(a.nz, TILE);
  const size_t smem = push_smem<T>(a.nout);
  int err = (int)cudaFuncSetAttribute(
      push3d<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)push_smem<T>(NOUT));
  if (err) return err;
  push3d<T><<<nblocks, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: enum Ptr; ints: enum Int; reals: enum Real (see above).
LP_EXPORT int lp_push_3d(void** ptrs, const long long* ints,
                         const double* reals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ints[I_DOUBLE]) return launch<double>(ptrs, ints, reals, st);
  return launch<float>(ptrs, ints, reals, st);
}
